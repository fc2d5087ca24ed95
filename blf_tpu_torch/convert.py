"""State carried between the JAX package and the port, as numpy arrays.

No counterpart in ``blf_tpu``. The system has no weights; what both sides
share is the problem, the solver state, the rigid-body state, the whole-body
task, the control stack's state (with its momentum observer), the contact
parameters, the foot's parameters and state, an RLS filter's state, an LQ
problem and the LQR, SQP and DCM-planner solutions (a kinematic tree is plain
numpy on both sides already). Every converter takes or returns
plain numpy arrays (``np.asarray`` of a JAX array on the other side), so this
module needs nothing of the JAX package.

With :func:`factors_from_numpy` a caller hands one side's factorization to
the other side's solver, so that the iteration is compared on identical
operators. That matters: the DCM transcription is x/y-symmetric, every
pencil eigenvalue is (at least) doubly degenerate, and two ``eigh``
implementations return different bases ``W`` inside each eigenspace.
``K(s)^-1 = W diag(1 / (1 + s d)) W'`` is the same; ``tau``, ``W`` and ``G2``
are not, and must never be compared entrywise.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Union

import numpy as np
import torch

from blf_tpu_torch.estimators.rls import RLSState
from blf_tpu_torch.estimators.wrench_observer import MomentumObserverState
from blf_tpu_torch.models.contact import ContactParams
from blf_tpu_torch.models.foot import FootParams, FootState
from blf_tpu_torch.models.lipm import LIPMParams
from blf_tpu_torch.models.rigid_body import FloatingBaseState
from blf_tpu_torch.mpc.dcm_planner import DCMPlannerSolution
from blf_tpu_torch.mpc.qp import QPSolution, SharedQPFactors
from blf_tpu_torch.mpc.riccati import LQRSolution
from blf_tpu_torch.mpc.sqp import SQPSolution
from blf_tpu_torch.mpc.stack import StackState
from blf_tpu_torch.mpc.wholebody import WholeBodyTask
from blf_tpu_torch.parallel.sweep import FleetState
from blf_tpu_torch.utils.device import resolve_device, resolve_dtype

__all__ = ["lipm_params_from_numpy", "factors_from_numpy",
           "fleet_state_from_numpy", "fleet_state_to_numpy",
           "qp_solution_to_numpy", "floating_base_state_from_numpy",
           "floating_base_state_to_numpy", "wholebody_task_from_numpy",
           "momentum_observer_state_from_numpy", "momentum_observer_state_to_numpy",
           "stack_state_from_numpy", "stack_state_to_numpy",
           "contact_params_from_numpy", "contact_params_to_numpy",
           "foot_params_from_numpy", "foot_state_from_numpy", "foot_state_to_numpy",
           "rls_state_from_numpy", "rls_state_to_numpy", "lqr_problem_from_numpy",
           "lqr_solution_to_numpy", "sqp_solution_to_numpy", "dcm_planner_solution_to_numpy"]


def _fields(obj: Union[Mapping[str, Any], Any], names) -> Dict[str, Any]:
    """Read ``names`` from a mapping or from an object's attributes (a
    NamedTuple of the other package, for instance)."""
    if isinstance(obj, Mapping):
        return {k: obj.get(k) for k in names}
    return {k: getattr(obj, k, None) for k in names}


def _to_numpy(t) -> Optional[np.ndarray]:
    return None if t is None else t.detach().cpu().numpy()


def lipm_params_from_numpy(com_height, gravity, *, device=None,
                           dtype: Optional[torch.dtype] = None) -> LIPMParams:
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    as_t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    return LIPMParams(as_t(com_height), as_t(gravity))


def factors_from_numpy(factors, *, device=None,
                       dtype: Optional[torch.dtype] = None) -> SharedQPFactors:
    """Build :class:`SharedQPFactors` from a mapping or an object with the
    same field names holding array-likes. A missing ``G2`` is recomputed as
    ``A_s @ W``. ``key`` stays None: such factors are never taken for reuse."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    vals = _fields(factors, [f for f in SharedQPFactors._fields if f != "key"])
    out = {}
    for name, val in vals.items():
        if val is None:
            if name != "G2":
                raise ValueError(f"factors lack the field {name!r}")
            continue
        # np.array copies: arrays handed over by JAX are read-only views
        out[name] = torch.as_tensor(
            np.array(val), dtype=dtype, device=device).contiguous()
    if "G2" not in out:
        out["G2"] = out["A_s"] @ out["W"]
    return SharedQPFactors(**out)


def fleet_state_from_numpy(state, *, device=None,
                           dtype: Optional[torch.dtype] = None) -> FleetState:
    """:class:`FleetState` from a mapping or an object with its field names."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    vals = _fields(state, FleetState._fields)
    missing = [k for k, v in vals.items() if v is None]
    if missing:
        raise ValueError(f"fleet state lacks the fields {missing}")
    return FleetState(**{
        k: torch.as_tensor(np.array(v), dtype=dtype, device=device)
        for k, v in vals.items()})


def fleet_state_to_numpy(state: FleetState) -> Dict[str, np.ndarray]:
    return {k: _to_numpy(v) for k, v in state._asdict().items()}


def qp_solution_to_numpy(sol: QPSolution) -> Dict[str, Optional[np.ndarray]]:
    return {k: _to_numpy(v) for k, v in sol._asdict().items()}


def _named_tuple_from_numpy(cls, obj, device, dtype, optional=()):
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    vals = _fields(obj, cls._fields)
    missing = [k for k, v in vals.items() if v is None and k not in optional]
    if missing:
        raise ValueError(f"{cls.__name__} lacks the fields {missing}")
    return cls(**{
        k: None if v is None else torch.as_tensor(np.array(v), dtype=dtype, device=device)
        for k, v in vals.items()})


def floating_base_state_from_numpy(state, *, device=None,
                                   dtype: Optional[torch.dtype] = None
                                   ) -> FloatingBaseState:
    """:class:`FloatingBaseState` from a mapping or an object with its field
    names (the JAX package's state, for instance)."""
    return _named_tuple_from_numpy(FloatingBaseState, state, device, dtype)


def floating_base_state_to_numpy(state: FloatingBaseState) -> Dict[str, np.ndarray]:
    return {k: _to_numpy(v) for k, v in state._asdict().items()}


def wholebody_task_from_numpy(task, *, device=None,
                              dtype: Optional[torch.dtype] = None) -> WholeBodyTask:
    """:class:`WholeBodyTask` from a mapping or an object with its field
    names; ``ext_wrench`` may be missing."""
    return _named_tuple_from_numpy(WholeBodyTask, task, device, dtype,
                                   optional=("ext_wrench",))


def momentum_observer_state_from_numpy(state, *, device=None,
                                       dtype: Optional[torch.dtype] = None
                                       ) -> MomentumObserverState:
    return _named_tuple_from_numpy(MomentumObserverState, state, device, dtype)


def momentum_observer_state_to_numpy(state: MomentumObserverState) -> Dict[str, np.ndarray]:
    return {k: _to_numpy(v) for k, v in state._asdict().items()}


def stack_state_from_numpy(state, *, device=None,
                           dtype: Optional[torch.dtype] = None) -> StackState:
    """:class:`StackState` from a mapping or an object with its field names
    (the JAX package's state, for instance); ``plant`` and ``observer`` are
    such mappings or objects in their turn."""
    vals = _fields(state, StackState._fields)
    missing = [k for k, v in vals.items() if v is None]
    if missing:
        raise ValueError(f"StackState lacks the fields {missing}")
    nested = {"plant": floating_base_state_from_numpy,
              "observer": momentum_observer_state_from_numpy}
    out = {k: nested[k](v, device=device, dtype=dtype) for k, v in vals.items()
           if k in nested}
    flat = _named_tuple_from_numpy(
        StackState, {k: v for k, v in vals.items() if k not in nested},
        device, dtype, optional=tuple(nested))
    return flat._replace(**out)


def stack_state_to_numpy(state: StackState) -> Dict[str, Any]:
    """Numpy arrays, with ``plant`` and ``observer`` as nested mappings."""
    out = {k: _to_numpy(v) for k, v in state._asdict().items()
           if k not in ("plant", "observer")}
    out["plant"] = floating_base_state_to_numpy(state.plant)
    out["observer"] = momentum_observer_state_to_numpy(state.observer)
    return out


def contact_params_from_numpy(params, *, device=None,
                              dtype: Optional[torch.dtype] = None) -> ContactParams:
    """:class:`ContactParams` from a mapping or an object with its field names."""
    return _named_tuple_from_numpy(ContactParams, params, device, dtype)


def contact_params_to_numpy(params: ContactParams) -> Dict[str, np.ndarray]:
    return {k: np.asarray(_to_numpy(v) if isinstance(v, torch.Tensor) else v)
            for k, v in params._asdict().items()}


def foot_params_from_numpy(params, *, device=None,
                           dtype: Optional[torch.dtype] = None) -> FootParams:
    """:class:`FootParams` from a mapping or an object with its field names."""
    return _named_tuple_from_numpy(FootParams, params, device, dtype)


def foot_state_from_numpy(state, *, device=None,
                          dtype: Optional[torch.dtype] = None) -> FootState:
    """:class:`FootState` from a mapping or an object with its field names."""
    return _named_tuple_from_numpy(FootState, state, device, dtype)


def foot_state_to_numpy(state: FootState) -> Dict[str, np.ndarray]:
    return {k: _to_numpy(v) for k, v in state._asdict().items()}


def rls_state_from_numpy(state, *, device=None,
                         dtype: Optional[torch.dtype] = None) -> RLSState:
    """:class:`RLSState` from a mapping or an object with its field names."""
    return _named_tuple_from_numpy(RLSState, state, device, dtype)


def rls_state_to_numpy(state: RLSState) -> Dict[str, np.ndarray]:
    return {k: _to_numpy(v) for k, v in state._asdict().items()}


def lqr_problem_from_numpy(Fs, cs, Ls, Qs, Rs, QT, x0, *, device=None,
                           dtype: Optional[torch.dtype] = None):
    """The arguments of ``solve_lqr`` (``(Fs, cs, Ls, Qs, Rs, QT, x0)``) as
    tensors, from array-likes (the JAX package's arrays, for instance)."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    return tuple(torch.as_tensor(np.array(a), dtype=dtype, device=device)
                 for a in (Fs, cs, Ls, Qs, Rs, QT, x0))


def lqr_solution_to_numpy(sol: LQRSolution) -> Dict[str, np.ndarray]:
    return {k: _to_numpy(v) for k, v in sol._asdict().items()}


def sqp_solution_to_numpy(sol: SQPSolution) -> Dict[str, np.ndarray]:
    return {k: _to_numpy(v) for k, v in sol._asdict().items()}


def dcm_planner_solution_to_numpy(sol: DCMPlannerSolution) -> Dict[str, np.ndarray]:
    return {k: _to_numpy(v) for k, v in sol._asdict().items()}
