"""Batched fixed-iteration ADMM QP solver (OSQP-style).

Counterpart of ``blf_tpu/mpc/qp.py``, of which the port holds ``QPSolution``,
``SharedQPFactors``, ``factor_shared_qp``, ``solve_qp_factored``,
``solve_qp_shared`` (the shared-operator fleet path), ``shard_factors_rows``
and ``solve_qp_factored_rowsharded`` (one shared-operator solve's constraint
rows split over the ranks of a mesh axis) and ``solve_qp``,
``solve_qp_lanes`` (per-lane operators).

Problem form (OSQP):  ``min 1/2 x'Px + q'x  s.t.  l <= Ax <= u``. There is no
data-dependent control flow anywhere: a fixed iteration count and per-lane
convergence flags.

**Shared operators** (:func:`solve_qp_factored`): a fleet of lanes shares ONE
``(P, A)`` and differs in ``(q, l, u)``. The KKT system is factored once,
spectrally, so that every lane carries its own continuously adapted penalty
multiplier ``s`` at shared-factorization cost, and the iteration collapses
onto the pre-clip constraint-space point ``v`` (two products against
``G2 = A W`` an iteration).

**Per-lane operators** (:func:`solve_qp`): every lane has its own ``(P, A)``,
as the whole-body QP has. ``backend="torch"`` (the reference's ``"xla"``) is
the alpha-relaxed (x, z, y) iteration with a batched Cholesky a stage;
``backend="cuda"`` (the reference's ``"pallas"``) dispatches to
:func:`solve_qp_lanes`, the v-space iteration on the two hand-written
kernels :func:`blf_tpu_torch.ops.cuda.linalg.cholesky_inverse_lane` and
:func:`blf_tpu_torch.ops.cuda.admm_lane.admm_lane_stage`. The two paths
adapt the penalty by different rules, as the reference's do; each mirrors
its own.

Backends of :func:`solve_qp_factored`:

- ``"torch"``: plain tensor ops (the reference's ``backend="xla"``),
  including ``refine``, the x5 hysteresis of the per-lane penalty rule and
  the per-lane acceptance of the dual polish.
- ``"cuda"``: the stage runs in the hand-written kernel
  :func:`blf_tpu_torch.ops.cuda.admm.admm_stage` with ``matmul="f32"`` (the
  reference's ``backend="pallas_f32"``); stage-boundary math and the finish
  are the same tensor ops. Exact f32 arithmetic, no refinement.
- ``"cuda_split"``, ``"cuda_delta"``: the same, with the stage on the
  tensor-core kernel in mode ``matmul="split"`` (3-pass bf16 split products,
  the reference's ``"pallas_split"``) or ``matmul="delta"`` (delta-form
  accumulation, the reference's ``"pallas"``, which ``bench.py`` runs).
  float32 only, no refinement; held to the reference's loose contract for
  these modes (the 1e-4 tolerance).

The kernel backends take any batch size: the kernels mask their own ragged
edge, and none of these backends ever gives way to another (the reference's
``batch % 256`` fall-back to XLA is a TPU matter).
"""

from __future__ import annotations

import warnings
from typing import NamedTuple, Optional

import torch

from blf_tpu_torch.ops.cuda.admm import admm_stage
from blf_tpu_torch.ops.cuda.admm_lane import admm_lane_stage
from blf_tpu_torch.ops.cuda.linalg import cholesky_inverse_lane
from blf_tpu_torch.ops.linalg import cholesky_nan
from blf_tpu_torch.ops.precision import f32_matmuls
from blf_tpu_torch.parallel.collectives import pmax_tree, psum_tree
from blf_tpu_torch.utils.profiling import trace

__all__ = ["QPSolution", "SharedQPFactors", "FactorKey", "factor_shared_qp",
           "solve_qp_factored", "solve_qp_shared", "shard_factors_rows",
           "solve_qp_factored_rowsharded", "solve_qp", "solve_qp_lanes", "BACKENDS",
           "SPANS"]

#: the spans of the shared-operator path (:func:`blf_tpu_torch.utils.profiling.trace`):
#: ``dcm.factor`` around :func:`factor_shared_qp` (Ruiz, Cholesky, ``eigh``,
#: ``W``, ``G2``, the casts), with ``sync.cholesky`` and ``sync.eigh`` around
#: the two decompositions that wait for the device (the Cholesky reads its
#: status, the float64 ``eigh`` its result) and ``sync.h2d`` around a copy
#: from the host; handed factors to reuse, ``sync.factor_key`` around the one
#: read-back of the check that they were made from the same inputs, and
#: ``dcm.factor_reused`` (empty) where they were, in place of the rest; in
#: :func:`solve_qp_factored`, ``qp.prepare`` (the scaling
#: of q, l, u, the v-space warm start, ``q W``), then a ``qp.stage`` (the
#: stage's iterations) and a ``qp.boundary`` (residuals, the penalty rule,
#: v re-expressed) a stage, and ``qp.finish`` (the unscaled iterate, the
#: polish when asked, the flags and objective)
SPANS = ("dcm.factor", "sync.cholesky", "sync.eigh", "sync.h2d", "sync.factor_key",
         "dcm.factor_reused", "qp.prepare", "qp.stage", "qp.boundary", "qp.finish")

BACKENDS = ("torch", "cuda", "cuda_split", "cuda_delta")
#: the stage kernel's matmul mode of each kernel backend of solve_qp_factored
_STAGE_MATMUL = {"cuda": "f32", "cuda_split": "split", "cuda_delta": "delta"}


class QPSolution(NamedTuple):
    """Per-lane solution + diagnostics (no exceptions on device)."""

    x: torch.Tensor                # (..., n) primal solution
    y: torch.Tensor                # (..., m) dual solution
    z: torch.Tensor                # (..., m) constraint-space iterate
    primal_residual: torch.Tensor  # (...,) |Ax - z|_inf
    dual_residual: torch.Tensor    # (...,) |Px + q + A'y|_inf
    converged: torch.Tensor        # (...,) bool
    objective: torch.Tensor        # (...,) 1/2 x'Px + q'x
    rho_scale: Optional[torch.Tensor] = None  # (..., 1) adapted multiplier s
    refined: Optional[torch.Tensor] = None    # () bool: refinement actually ran


class SharedQPFactors(NamedTuple):
    """One-time spectral factorization of a fleet-shared QP (P, A).

    The per-lane adaptive penalty is a scalar multiplier ``s`` on the
    structural rho vector: ``K(s) = P + sigma I + s A' rho A``. With
    ``P + sigma I = L L'`` and the pencil
    ``L^-1 (A' rho A) L^-T = U diag(d) U'``, ``W = L^-T U`` gives

        ``K(s)^-1 = W diag(1 / (1 + s d)) W'``  for every ``s`` at once.

    All members are in the Ruiz-equilibrated frame.
    """

    P_s: torch.Tensor        # (n, n) scaled cost matrix
    A_s: torch.Tensor        # (m, n) scaled constraints
    R2: torch.Tensor         # (n, n) A' diag(rho) A
    W: torch.Tensor          # (n, n) spectral basis L^-T U
    d: torch.Tensor          # (n,) pencil eigenvalues (>= 0)
    base_rho: torch.Tensor   # (m,) structural rho (stiff on equality rows)
    D: torch.Tensor          # (n,) Ruiz column scaling
    E: torch.Tensor          # (m,) Ruiz row scaling
    c: torch.Tensor          # scalar cost normalization
    sigma: torch.Tensor      # scalar ADMM sigma
    P_orig: torch.Tensor     # (n, n) unscaled, for diagnostics
    A_orig: torch.Tensor     # (m, n) unscaled
    G2: Optional[torch.Tensor] = None  # (m, n) A W: the iteration operator
    key: Optional["FactorKey"] = None  # what they were made from, for reuse


class FactorKey(NamedTuple):
    """What :func:`factor_shared_qp` made a :class:`SharedQPFactors` from: a
    copy of the bytes of ``P``, ``A`` and ``is_eq`` end to end, their dtypes
    and shapes, and the four settings by name (``rho``, ``sigma``,
    ``rho_eq_scale``, ``scaling_iters``)."""

    data: torch.Tensor       # (k,) uint8, on the inputs' device
    layout: tuple            # (dtype, shape) of P, A and is_eq
    settings: dict


@torch.no_grad()
@f32_matmuls
def factor_shared_qp(
    P: torch.Tensor,
    A: torch.Tensor,
    is_eq: torch.Tensor,
    *,
    rho: float = 1.0,
    sigma: float = 1e-6,
    rho_eq_scale: float = 30.0,
    scaling_iters: int = 10,
    reuse: Optional[SharedQPFactors] = None,
) -> SharedQPFactors:
    """Ruiz-equilibrate and spectrally factor a shared (P, A) pair.

    Depends only on ``(P, A, is_eq)`` and the four settings, not on
    ``q/l/u``. ``rho_eq_scale`` defaults to 30: the spectral form applies
    ``K(s)^-1`` through an eigenbasis whose solve error grows with
    ``cond(K)``, and per-lane penalty adaptation recovers the equality
    enforcement a stiffer rho would give.

    **Reuse.** Handed the factors of an earlier call as ``reuse``, it
    returns that very object when it was made from the same inputs:
    bitwise-equal ``P``, ``A`` and ``is_eq``, equal settings, the same dtype
    and device. Otherwise it factors anew. The check is three device
    operations and one bool read back (``sync.factor_key``), where the
    factorization is hundreds of operations and three waits for the device. The
    key holds a copy of the inputs' bytes, so an input edited in place after
    the call is a miss, not a stale hit. A caller whose transcription
    survives across control ticks passes the last tick's factors
    (``make_fleet_step`` does).

    **Float32 inputs are factored in float64 and cast.** The reference
    factors in the working dtype (``blf_tpu/mpc/qp.py:652-720``). The port
    does not: a float32 Cholesky, triangular inverse and Jacobi ``eigh`` on
    the GPU return a pencil basis ``W`` whose error left 9 % of a fleet's
    lanes inside tolerance on the third warm-started tick and kept the dual
    residual floor five times higher (PERF.md, "The tick-3 dip"). The
    matrices are small (n x n and m x n, once a call), so the whole body
    (Ruiz loop, ``R2``, Cholesky, ``L^-1``, ``eigh``, ``W``, ``G2``) runs in
    float64 on any device and every field is cast to float32 on return. The
    iteration that consumes the factors stays float32. Float64 inputs are
    factored as they are.
    """
    if P.dim() != 2 or A.dim() != 2:
        raise ValueError("factor_shared_qp requires unbatched P and A")
    settings = dict(rho=rho, sigma=sigma, rho_eq_scale=rho_eq_scale,
                    scaling_iters=scaling_iters)
    with trace("dcm.factor"):
        is_eq = torch.as_tensor(is_eq, device=P.device)
        if reuse is not None and _made_from(reuse, P, A, is_eq, settings):
            with trace("dcm.factor_reused"):
                return reuse
        if P.dtype == torch.float32:
            wide = _factor_shared_qp(P.double(), A.double(), is_eq, **settings)
            f = SharedQPFactors(*(None if t is None else t.to(torch.float32) for t in wide))
        else:
            f = _factor_shared_qp(P, A, is_eq, **settings)
        inputs = (P, A, is_eq)
        return f._replace(key=FactorKey(_data(inputs), _layout(inputs), settings))


def _data(inputs) -> torch.Tensor:
    # bytes, not values: -0.0 is not 0.0 here, and a NaN equals itself
    return torch.cat([t.contiguous().view(torch.uint8).view(-1) for t in inputs])


def _layout(inputs) -> tuple:
    return tuple((t.dtype, tuple(t.shape)) for t in inputs)


def _made_from(f: SharedQPFactors, P, A, is_eq, settings) -> bool:
    """Whether ``f`` was factored from exactly these inputs: the settings,
    device, dtypes and shapes on the host, the bytes on the device, one bool
    read back."""
    inputs = (P, A, is_eq)
    if (f.key is None or f.key.settings != settings or f.key.data.device != P.device
            or f.key.layout != _layout(inputs)):
        return False
    data = _data(inputs)
    with trace("sync.factor_key"):
        return torch.equal(data, f.key.data)


def _factor_shared_qp(P, A, is_eq, *, rho, sigma, rho_eq_scale,
                      scaling_iters) -> SharedQPFactors:
    """The factorization of :func:`factor_shared_qp` in the dtype of ``P``."""
    n, m = P.shape[-1], A.shape[-2]
    dtype, device = P.dtype, P.device
    P_orig, A_orig = P, A

    D = torch.ones((n,), dtype=dtype, device=device)
    E = torch.ones((m,), dtype=dtype, device=device)
    one = torch.ones((), dtype=dtype, device=device)
    for _ in range(scaling_iters):
        col_norm = torch.maximum(P.abs().amax(dim=0), A.abs().amax(dim=0))
        dx = 1.0 / torch.sqrt(torch.where(col_norm > 1e-12, col_norm, one))
        row_norm = A.abs().amax(dim=1)
        de = 1.0 / torch.sqrt(torch.where(row_norm > 1e-12, row_norm, one))
        P = dx[:, None] * P * dx[None, :]
        A = de[:, None] * A * dx[None, :]
        D, E = D * dx, E * de
    # cost normalization from P alone (NOT q: keeps the factorization
    # tick-invariant; the per-lane adaptive s absorbs the difference)
    p_cols = P.abs().amax(dim=0).mean()
    c = 1.0 / torch.clamp(p_cols, min=1e-12)
    P = c * P

    is_eq = torch.as_tensor(is_eq, device=device)
    base_rho = torch.where(
        is_eq, one * (rho * rho_eq_scale), one * rho).to(dtype)
    R2 = A.T @ (base_rho[:, None] * A)
    eye = torch.eye(n, dtype=dtype, device=device)
    P_sig = P + sigma * eye
    with trace("sync.cholesky"):            # reads the factorization's status
        L = torch.linalg.cholesky(P_sig)
    Linv = torch.linalg.solve_triangular(L, eye, upper=False)
    M = Linv @ R2 @ Linv.T
    M = 0.5 * (M + M.T)
    with trace("sync.eigh"):
        d, U = torch.linalg.eigh(M)
    d = torch.clamp(d, min=0.0)
    W = Linv.T @ U
    with trace("sync.h2d"):
        sigma = torch.as_tensor(sigma, dtype=dtype, device=device)
    return SharedQPFactors(
        P_s=P, A_s=A, R2=R2, W=W, d=d, base_rho=base_rho, D=D, E=E,
        c=c.to(dtype), sigma=sigma, P_orig=P_orig, A_orig=A_orig, G2=A @ W,
    )


def _clip(v, l, u):
    # min(max(v, l), u): a NaN of any operand stays NaN, as in jnp.clip
    return torch.minimum(torch.maximum(v, l), u)


def _amax(t):
    return t.abs().amax(dim=-1)


@torch.no_grad()
@f32_matmuls
def solve_qp_factored(
    factors: SharedQPFactors,
    q: torch.Tensor,
    l: torch.Tensor,
    u: torch.Tensor,
    *,
    iterations: int = 200,
    alpha: float = 1.6,
    eps_abs: float = 1e-5,
    eps_rel: float = 1e-5,
    check_every: int = 25,
    x0: Optional[torch.Tensor] = None,
    y0: Optional[torch.Tensor] = None,
    s0: Optional[torch.Tensor] = None,
    backend: str = "torch",
    refine: Optional[bool] = None,
    s_min: float = 1e-4,
    s_max: float = 1e4,
    polish_iters: int = 0,
    polish_scale: float = 0.1,
) -> QPSolution:
    """Solve a fleet of QPs against a prebuilt :class:`SharedQPFactors`.

    **v-space iteration.** The sigma x proximal term is dropped from the
    x-step rhs (the fixed point shifts by ``sigma |x|``, below the solver's
    residual floor). The primal iterate then never feeds back, and the whole
    OSQP iteration collapses onto ``v = z_relaxed + y/rho``
    (``z = clip(v, l, u)``, ``y = rho (v - z)`` are recovered views).

    Every ``check_every`` iterations each lane moves its scalar ``s`` by its
    own primal/dual residual ratio (OSQP rule with x5 hysteresis, clipped to
    ``[s_min, s_max]``). ``iterations`` is rounded up to whole stages.
    ``refine`` adds one iterative-refinement pass per x-solve; it defaults to
    True on ``backend="torch"`` and is not supported by the kernel backends
    (``"cuda"``, ``"cuda_split"``, ``"cuda_delta"``), where asking for it
    warns and ``QPSolution.refined`` records False.

    ``polish_iters > 0`` appends a final stage at ``s * polish_scale``,
    accepted per lane only where it lowered the tolerance-normalized
    residual score. ``rho_scale`` returns the adapted ``s``, not the polished
    one: it is the warm start of the next receding-horizon tick.

    Shapes: ``q`` (..., n), ``l``/``u`` (..., m), broadcast against each other
    over the leading axes; ``x0`` (..., n), ``y0`` (..., m), ``s0`` (..., 1).
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")
    f = factors
    n, m = f.P_s.shape[-1], f.A_s.shape[-2]
    dtype, device = f.P_s.dtype, f.P_s.device
    is_kernel = backend in _STAGE_MATMUL
    if refine and is_kernel:
        warnings.warn(
            "refine=True is not supported by the fused CUDA ADMM kernel; "
            "running without iterative refinement (see QPSolution.refined). "
            "Use backend='torch' for refined solves.",
            stacklevel=2,
        )
    refine = (not is_kernel) if refine is None else (refine and not is_kernel)

    with trace("qp.prepare"):
        q_orig = q
        batch = torch.broadcast_shapes(q.shape[:-1], l.shape[:-1], u.shape[:-1])
        flat = lambda t, k: t.broadcast_to(batch + (k,)).reshape(-1, k)

        A, P, sigma = f.A_s, f.P_s, f.sigma
        qb = flat(f.c * (q * f.D), n)
        lb = flat(f.E * l, m).contiguous()
        ub = flat(f.E * u, m).contiguous()
        qo = flat(q_orig, n)
        B = qb.shape[0]

        # per-lane warm penalty state first: the v-space init depends on rho(s)
        if s0 is None:
            s = torch.ones((B, 1), dtype=dtype, device=device)
        else:
            s = flat(torch.as_tensor(s0, dtype=dtype, device=device), 1).contiguous()
        if x0 is None:
            z = torch.zeros((B, m), dtype=dtype, device=device)
        else:
            z = flat(x0 / f.D, n) @ A.T
        y = torch.zeros_like(z) if y0 is None else flat(f.c * y0 / f.E, m)

        G2 = f.G2 if f.G2 is not None else A @ f.W
        G2 = G2.contiguous()
        G2t = G2.T
        gq = (qb @ f.W).contiguous()      # q W: constant across stages

        # v = z + y/rho, so z = clip(v, l, u) and y = rho (v - z) are recovered
        # views. Warm starts from a previous solve satisfy the complementarity
        # this encodes; otherwise iteration 1 re-projects.
        v = z + y / (s * f.base_rho)
        # aux primal carry: spectral tau (x = tau W') on the fast path,
        # materialized x when refining. Neither feeds back into the v recursion,
        # so 0 is an exact init (overwritten on the first iteration).
        tau = torch.zeros((B, n), dtype=dtype, device=device)

    def x_of(tau):
        return tau if refine else tau @ f.W.T

    def Ax_of(tau):
        return tau @ A.T if refine else tau @ G2t

    def run_stage_torch(v, tau, s, iters):
        rho_lane = s * f.base_rho                          # (B, m)
        dinv = 1.0 / (1.0 + s * f.d)                       # (B, n)
        for _ in range(iters):
            z = _clip(v, lb, ub)
            w = rho_lane * (2.0 * z - v)
            t = w @ G2 - gq                                # = rhs W
            if refine:
                # accuracy path: materialize x, one iterative-refinement
                # pass against K(s) = P + sigma I + s R2 through the eigenbasis
                x1 = (t * dinv) @ f.W.T
                Kx1 = x1 @ P + sigma * x1 + s * (x1 @ f.R2)
                rhs = w @ A - qb
                t2 = ((rhs - Kx1) @ f.W) * dinv
                tau = x1 + t2 @ f.W.T
                v = v + alpha * (tau @ A.T - z)
            else:
                tau = t * dinv                             # x = tau W'
                v = v + alpha * (tau @ G2t - z)
        return v, tau

    def run_stage_kernel(v, tau, s, iters):
        return admm_stage(v.contiguous(), tau, s.contiguous(), gq, lb, ub, G2,
                          f.d, f.base_rho, iters=iters, alpha=alpha,
                          matmul=_STAGE_MATMUL[backend])

    run_stage = run_stage_kernel if is_kernel else run_stage_torch

    check_every = max(1, min(check_every, iterations))
    n_stages = max(1, -(-iterations // check_every))

    for _ in range(n_stages):
        with trace("qp.stage"):
            v, tau = run_stage(v, tau, s, check_every)
        with trace("qp.boundary"):
            z = _clip(v, lb, ub)
            y = (s * f.base_rho) * (v - z)
            x = x_of(tau)
            Ax = Ax_of(tau)
            Px_ = x @ P.T
            Aty_ = y @ A
            rp = _amax(Ax - z) / torch.clamp(
                torch.maximum(_amax(Ax), _amax(z)), min=1e-12)
            rd = _amax(Px_ + qb + Aty_) / torch.clamp(
                torch.maximum(_amax(Px_), torch.maximum(_amax(Aty_), _amax(qb))),
                min=1e-12)
            # OSQP per-lane rho rule with hysteresis: move by the residual ratio
            # only when it leaves [1/5, 5] (continuous s, no ladder quantization)
            ratio = torch.sqrt(rp / torch.clamp(rd, min=1e-12))[..., None]
            move = (ratio > 5.0) | (ratio < 0.2)
            s_new = torch.where(move, torch.clamp(s * ratio, s_min, s_max), s)
            # rho changed => re-express v so the recovered (z, y) views are
            # invariant: rho_old (v_old - z) = y = rho_new (v_new - z)
            v = z + (s / s_new) * (v - z)
            s = s_new

    def finish(v, tau, rho_lane):
        """Recover (x, z, y), unscale, diagnose in the ORIGINAL problem."""
        x = x_of(tau)
        z = _clip(v, lb, ub)
        y = rho_lane * (v - z)
        x = f.D * x
        y = f.E * y / f.c
        z = z / f.E
        Ax = x @ f.A_orig.T
        r_prim = _amax(Ax - z)
        Px = x @ f.P_orig.T
        Aty = y @ f.A_orig
        r_dual = _amax(Px + qo + Aty)
        prim_tol = eps_abs + eps_rel * torch.maximum(_amax(Ax), _amax(z))
        dual_tol = eps_abs + eps_rel * torch.maximum(
            torch.maximum(_amax(Px), _amax(Aty)), _amax(qo))
        return x, z, y, r_prim, r_dual, prim_tol, dual_tol, Px

    with trace("qp.finish"):
        cand = finish(v, tau, s * f.base_rho)
        if polish_iters > 0:
            # rho-continuation dual polish: y's granularity is proportional to s,
            # so a short low-s tail lets the duals settle on converged lanes;
            # lanes still far from their fixed point can be pushed AWAY by low-rho
            # iterations, so the polish is accepted per lane only where it
            # lowered the tolerance-normalized residual score. s itself is NOT
            # polished: the warm-start s of the next tick stays at the adapted
            # operating point.
            s_pol = torch.clamp(s * polish_scale, s_min, s_max)
            z = _clip(v, lb, ub)
            v_p = z + (s / s_pol) * (v - z)
            v_p, tau_p = run_stage(v_p, tau, s_pol, polish_iters)
            pol = finish(v_p, tau_p, s_pol * f.base_rho)
            score = lambda r: torch.maximum(r[3] / r[5], r[4] / r[6])
            better = score(pol) < score(cand)
            pick = lambda a, b: torch.where(
                better[:, None] if a.dim() == 2 else better, b, a)
            cand = tuple(pick(a, b) for a, b in zip(cand, pol))

        x, z, y, r_prim, r_dual, prim_tol, dual_tol, Px = cand
        converged = (r_prim < prim_tol) & (r_dual < dual_tol)
        objective = 0.5 * (x * Px).sum(dim=-1) + (qo * x).sum(dim=-1)
        return QPSolution(
            x.reshape(batch + (n,)), y.reshape(batch + (m,)),
            z.reshape(batch + (m,)), r_prim.reshape(batch),
            r_dual.reshape(batch), converged.reshape(batch),
            objective.reshape(batch), rho_scale=s.reshape(batch + (1,)),
            refined=torch.full((), bool(refine), dtype=torch.bool, device=device))


def solve_qp_shared(
    P: torch.Tensor,
    q: torch.Tensor,
    A: torch.Tensor,
    l: torch.Tensor,
    u: torch.Tensor,
    *,
    rho: float = 1.0,
    sigma: float = 1e-6,
    rho_eq_scale: float = 30.0,
    scaling_iters: int = 10,
    **solve_kwargs,
) -> QPSolution:
    """ADMM for a scenario fleet sharing ONE (P, A) with per-lane (q, l, u).

    Convenience wrapper around :func:`factor_shared_qp` +
    :func:`solve_qp_factored` (which takes ``solve_kwargs``); hoist the
    factorization yourself when (P, A) survive across control ticks.

    Shapes: ``P`` (n, n), ``A`` (m, n), strictly unbatched; ``q`` (..., n),
    ``l``/``u`` (..., m) carry the batch.
    """
    m = A.shape[-2]
    # the equality pattern must be lane-independent for a shared
    # factorization: a row is stiff iff it is an equality in EVERY lane
    is_eq = ((u - l) < 1e-12).reshape(-1, m).all(dim=0)
    factors = factor_shared_qp(
        P, A, is_eq, rho=rho, sigma=sigma, rho_eq_scale=rho_eq_scale,
        scaling_iters=scaling_iters,
    )
    return solve_qp_factored(factors, q, l, u, **solve_kwargs)


def shard_factors_rows(f: SharedQPFactors, index: int, num_shards: int) -> SharedQPFactors:
    """Row block ``index`` of ``num_shards`` of a :class:`SharedQPFactors`.

    Every member indexed by the constraint rows (``A_s``, ``A_orig``, ``E``,
    ``base_rho``, ``G2``) is cut to the block; the n-indexed members are
    kept whole. ``m`` must divide evenly: pad the transcription with vacuous
    rows (+-inf bounds, a zero row of A) if it does not.
    """
    m = f.A_s.shape[-2]
    if m % num_shards:
        raise ValueError(f"m={m} not divisible by {num_shards} row shards")
    rows = slice(index * (m // num_shards), (index + 1) * (m // num_shards))
    G2 = f.G2 if f.G2 is not None else f.A_s @ f.W
    return f._replace(A_s=f.A_s[rows], A_orig=f.A_orig[rows], E=f.E[rows],
                      base_rho=f.base_rho[rows], G2=G2[rows])


@torch.no_grad()
@f32_matmuls
def solve_qp_factored_rowsharded(
    factors: SharedQPFactors,
    q: torch.Tensor,
    l: torch.Tensor,
    u: torch.Tensor,
    *,
    group,
    iterations: int = 200,
    alpha: float = 1.6,
    eps_abs: float = 1e-5,
    eps_rel: float = 1e-5,
    check_every: int = 25,
    s0: Optional[torch.Tensor] = None,
) -> QPSolution:
    """One shared-operator ADMM solve with its constraint rows split over the
    ranks of ``group`` (tensor/model parallelism within a solve).

    Called by every rank of ``group`` (the reference's ``shard_map`` body):
    ``factors`` is the rank's row block (:func:`shard_factors_rows`), ``l``
    and ``u`` the matching ``(..., m_local)`` bounds, ``q`` the whole
    ``(..., n)``. An iteration's only traffic is one sum over the group of
    the ``(..., n)`` partial contraction ``w G2_local``; the constraint-space
    iterates (v, z, y) never leave their rank. At each check the residuals
    add a sum of ``A' y`` and maxima over the group. Cold start, the
    v-space iteration and per-lane penalty rule of
    :func:`solve_qp_factored`, without refinement or polish.

    Returns a :class:`QPSolution` whose ``x``, residuals, ``converged``,
    ``objective`` and ``rho_scale`` are the same on every rank and whose
    ``y``/``z`` are the rank's rows. The contractions are plain products, as
    in the reference (no kernel).
    """
    f = factors
    n, m_loc = f.P_s.shape[-1], f.A_s.shape[-2]
    dtype, device = f.P_s.dtype, f.P_s.device
    q_orig = q
    batch = torch.broadcast_shapes(q.shape[:-1], l.shape[:-1], u.shape[:-1])
    A, P, G2 = f.A_s, f.P_s, f.G2
    qb = (f.c * (q * f.D)).broadcast_to(batch + (n,))
    lb = (f.E * l).broadcast_to(batch + (m_loc,))
    ub = (f.E * u).broadcast_to(batch + (m_loc,))
    s = (torch.ones((1,), dtype=dtype, device=device) if s0 is None
         else torch.as_tensor(s0, dtype=dtype, device=device)).broadcast_to(batch + (1,))
    gq = qb @ f.W

    # cold start in v-space (x = 0 => z = 0, y = 0 => v = 0)
    v = torch.zeros(batch + (m_loc,), dtype=dtype, device=device)
    tau = torch.zeros(batch + (n,), dtype=dtype, device=device)

    def run_stage(v, tau, s, iters):
        rho_lane = s * f.base_rho                          # (..., m_local)
        dinv = 1.0 / (1.0 + s * f.d)                       # (..., n)
        for _ in range(iters):
            z = _clip(v, lb, ub)
            w = rho_lane * (2.0 * z - v)
            t = psum_tree(w @ G2, group) - gq              # the one collective
            tau = t * dinv
            v = v + alpha * (tau @ G2.T - z)
        return v, tau

    check_every = max(1, min(check_every, iterations))
    for _ in range(max(1, -(-iterations // check_every))):
        v, tau = run_stage(v, tau, s, check_every)
        z = _clip(v, lb, ub)
        y = (s * f.base_rho) * (v - z)
        x = tau @ f.W.T
        Ax = tau @ G2.T
        Px_ = x @ P.T
        Aty_ = psum_tree(y @ A, group)
        prim, scale = pmax_tree((_amax(Ax - z), torch.maximum(_amax(Ax), _amax(z))), group)
        rp = prim / torch.clamp(scale, min=1e-12)
        rd = _amax(Px_ + qb + Aty_) / torch.clamp(
            torch.maximum(torch.maximum(_amax(Px_), _amax(Aty_)), _amax(qb)), min=1e-12)
        ratio = torch.sqrt(rp / torch.clamp(rd, min=1e-12))[..., None]
        move = (ratio > 5.0) | (ratio < 0.2)
        s_new = torch.where(move, torch.clamp(ratio * s, 1e-4, 1e4), s)
        v = z + (s / s_new) * (v - z)
        s = s_new

    x = f.D * (tau @ f.W.T)
    z = _clip(v, lb, ub)
    y = f.E * ((s * f.base_rho) * (v - z)) / f.c
    z = z / f.E
    Ax = x @ f.A_orig.T
    r_prim, scale = pmax_tree((_amax(Ax - z), torch.maximum(_amax(Ax), _amax(z))), group)
    Px = x @ f.P_orig.T
    Aty = psum_tree(y @ f.A_orig, group)
    r_dual = _amax(Px + q_orig + Aty)
    prim_tol = eps_abs + eps_rel * scale
    dual_tol = eps_abs + eps_rel * torch.maximum(torch.maximum(_amax(Px), _amax(Aty)),
                                                 _amax(q_orig))
    converged = (r_prim < prim_tol) & (r_dual < dual_tol)
    objective = 0.5 * (x * Px).sum(-1) + (q_orig * x).sum(-1)
    return QPSolution(x, y, z, r_prim, r_dual, converged, objective, rho_scale=s,
                      refined=torch.zeros((), dtype=torch.bool, device=device))


# ---------------------------------------------------------------------------
# Per-lane operators: solve_qp and solve_qp_lanes
# ---------------------------------------------------------------------------

def _mv(A, x):
    return torch.einsum("...mn,...n->...m", A, x)


def _mtv(A, y):
    return torch.einsum("...mn,...m->...n", A, y)


def _default_rho_eq_scale(dtype) -> float:
    # OSQP's 1e3 in float64, 30 in float32: the KKT solve error grows with
    # cond(K), which grows with rho_eq_scale, and at 1e3 a float32 dual
    # residual floors near 1e-1; the adaptive rho recovers the enforcement
    return 1e3 if torch.finfo(dtype).bits >= 64 else 30.0


def _ruiz_lanes(P, q, A, scaling_iters: int):
    """Per-lane Ruiz equilibration with cost normalisation:
    ``P_s = c D P D``, ``A_s = E A D``, ``q_s = c D q``. Returns
    ``(P_s, q_s, A_s, D, E, c)`` with ``D`` (..., n), ``E`` (..., m), ``c``
    (...,) over the broadcast batch of ``P`` and ``q``."""
    n, m = P.shape[-1], A.shape[-2]
    new = dict(dtype=P.dtype, device=P.device)
    D = torch.ones(P.shape[:-2] + (n,), **new)
    E = torch.ones(A.shape[:-2] + (m,), **new)
    c = torch.ones(torch.broadcast_shapes(P.shape[:-2], q.shape[:-1]), **new)
    one = torch.ones((), **new)
    for _ in range(scaling_iters):
        col_norm = torch.maximum(P.abs().amax(dim=-2), A.abs().amax(dim=-2))
        dx = 1.0 / torch.sqrt(torch.where(col_norm > 1e-12, col_norm, one))
        row_norm = A.abs().amax(dim=-1)
        de = 1.0 / torch.sqrt(torch.where(row_norm > 1e-12, row_norm, one))
        P = dx[..., :, None] * P * dx[..., None, :]
        A = de[..., :, None] * A * dx[..., None, :]
        q = q * dx
        D = D * dx
        E = E * de
        # cost normalisation
        p_cols = P.abs().amax(dim=-2).mean(dim=-1)
        gamma = 1.0 / torch.clamp(torch.maximum(p_cols, _amax(q)), min=1e-12)
        P = gamma[..., None, None] * P
        q = gamma[..., None] * q
        c = c * gamma
    return P, q, A, D, E, c


def _relative_residuals(P, q, A, x, z, y):
    """Scaled-frame relative primal and dual residuals (...,) that drive the
    penalty adaptation."""
    Ax, Px_, Aty_ = _mv(A, x), _mv(P, x), _mtv(A, y)
    rp = _amax(Ax - z) / torch.clamp(torch.maximum(_amax(Ax), _amax(z)), min=1e-12)
    rd = _amax(Px_ + q + Aty_) / torch.clamp(
        torch.maximum(_amax(Px_), torch.maximum(_amax(Aty_), _amax(q))), min=1e-12)
    return rp, rd


def _diagnose(P_orig, q_orig, A_orig, D, E, c, x, z, y):
    """Unscale an iterate and diagnose it in the ORIGINAL problem."""
    x = D * x
    y = E * y / c[..., None]
    z = z / E
    Ax = _mv(A_orig, x)
    r_prim = _amax(Ax - z)
    Px = _mv(P_orig, x)
    Aty = _mtv(A_orig, y)
    r_dual = _amax(Px + q_orig + Aty)
    # OSQP-style relative tolerances (scale-free convergence check)
    prim_tol_scale = torch.maximum(_amax(Ax), _amax(z))
    dual_tol_scale = torch.maximum(torch.maximum(_amax(Px), _amax(Aty)), _amax(q_orig))
    return x, z, y, r_prim, r_dual, prim_tol_scale, dual_tol_scale


def _pick_polished(cand, pol, eps_abs, eps_rel):
    """Per lane, the polished iterate where it lowered the tolerance-normalized
    residual score, else the unpolished one."""
    score = lambda r: torch.maximum(r[3] / (eps_abs + eps_rel * r[5]),
                                    r[4] / (eps_abs + eps_rel * r[6]))
    better = score(pol) < score(cand)
    pick = lambda a, b: torch.where(
        better.reshape(better.shape + (1,) * (a.dim() - better.dim())), b, a)
    return tuple(pick(a, b) for a, b in zip(cand, pol))


def _solution(cand, P_orig, q_orig, eps_abs, eps_rel, rho_scale, refined):
    x, z, y, r_prim, r_dual, prim_scale, dual_scale = cand
    converged = (r_prim < eps_abs + eps_rel * prim_scale) & (
        r_dual < eps_abs + eps_rel * dual_scale)
    objective = 0.5 * (x * _mv(P_orig, x)).sum(dim=-1) + (q_orig * x).sum(dim=-1)
    return QPSolution(x, y, z, r_prim, r_dual, converged, objective,
                      rho_scale=rho_scale, refined=refined)


@torch.no_grad()
@f32_matmuls
def solve_qp(
    P: torch.Tensor,
    q: torch.Tensor,
    A: torch.Tensor,
    l: torch.Tensor,
    u: torch.Tensor,
    *,
    iterations: int = 200,
    rho: float = 1.0,
    sigma: float = 1e-6,
    alpha: float = 1.6,
    eps_abs: float = 1e-5,
    eps_rel: float = 1e-5,
    rho_eq_scale: Optional[float] = None,
    scaling_iters: int = 10,
    check_every: int = 25,
    x0: Optional[torch.Tensor] = None,
    y0: Optional[torch.Tensor] = None,
    s0: Optional[torch.Tensor] = None,
    kkt_inverse: bool = True,
    kkt_refine: int = 3,
    polish_iters: int = 0,
    polish_scale: float = 0.1,
    backend: str = "torch",
) -> QPSolution:
    """Solve ``min 1/2 x'Px + q'x s.t. l <= Ax <= u`` with fixed-iteration ADMM.

    Shapes: ``P`` (..., n, n) SPSD, ``q`` (..., n), ``A`` (..., m, n), ``l``/``u``
    (..., m) (``-+inf`` for one-sided rows, ``l == u`` for equalities). ``x0``/
    ``y0`` warm-start the iteration, and ``s0`` (...,) or (..., 1) warm-starts
    the per-lane adaptive penalty multiplier (returned as
    ``QPSolution.rho_scale``).

    Iteration (alpha-relaxed ADMM, per-constraint penalty rho)::

        (P + sigma I + A' rho A) xt = sigma x - q + A'(rho z - y)
        x+ = alpha xt + (1 - alpha) x
        z+ = clip(alpha A xt + (1 - alpha) z + y / rho, l, u)
        y+ = y + rho (alpha A xt + (1 - alpha) z - z+)

    The KKT matrix is factored once a stage (batched Cholesky; a lane whose
    matrix is not positive definite turns NaN and no other lane does).
    ``kkt_inverse=True`` applies the factor as an explicit inverse with
    ``kkt_refine`` iterative-refinement passes against the exact KKT, so that
    an iteration is matrix-vector products only. Every ``check_every``
    iterations each lane's multiplier moves by its primal/dual residual ratio,
    clipped to a factor in [0.2, 5] a check and to [1e-6, 1e6] overall.
    ``scaling_iters`` rounds of Ruiz equilibration precondition each lane;
    residuals and the solution are reported in the ORIGINAL scaling.
    ``rho_eq_scale=None`` picks the equality-row stiffening by dtype (1e3 in
    float64, 30 in float32). ``polish_iters > 0`` appends a stage at
    ``rho_scale * polish_scale``, accepted per lane only where it lowered the
    tolerance-normalized residual score. ``QPSolution.refined`` stays ``None``
    on this backend, as in the reference.

    ``backend="cuda"`` dispatches to :func:`solve_qp_lanes`, the fused
    per-lane-operator kernel path (one batch axis required; ``kkt_inverse``
    and ``kkt_refine`` are knobs of the ``"torch"`` path and ignored there).
    """
    if backend == "cuda":
        return solve_qp_lanes(
            P, q, A, l, u, iterations=iterations, rho=rho, sigma=sigma,
            alpha=alpha, eps_abs=eps_abs, eps_rel=eps_rel,
            rho_eq_scale=rho_eq_scale, scaling_iters=scaling_iters,
            check_every=check_every, x0=x0, y0=y0, s0=s0,
            polish_iters=polish_iters, polish_scale=polish_scale)
    if backend != "torch":
        raise ValueError(f"unknown solve_qp backend {backend!r}; expected 'torch' or 'cuda'")
    n, m = P.shape[-1], A.shape[-2]
    dtype, device = P.dtype, P.device
    if rho_eq_scale is None:
        rho_eq_scale = _default_rho_eq_scale(dtype)

    P_orig, q_orig, A_orig = P, q, A
    P, q, A, D, E, c = _ruiz_lanes(P, q, A, scaling_iters)
    l = E * l
    u = E * u
    if x0 is not None:
        x0 = x0 / D                      # x_s = D^-1 x
    if y0 is not None:
        y0 = c[..., None] * y0 / E       # y_s = c E^-1 y

    is_eq = (u - l) < 1e-12
    one = torch.ones((), dtype=dtype, device=device)
    base_rho = torch.where(is_eq, one * (rho * rho_eq_scale), one * rho)

    batch = torch.broadcast_shapes(
        P.shape[:-2], q.shape[:-1], A.shape[:-2], l.shape[:-1], u.shape[:-1],
        () if x0 is None else x0.shape[:-1],
        () if y0 is None else y0.shape[:-1])
    new = dict(dtype=dtype, device=device)
    x = torch.zeros(batch + (n,), **new) if x0 is None else x0.broadcast_to(batch + (n,))
    z = _mv(A, x).broadcast_to(batch + (m,))
    y = torch.zeros(batch + (m,), **new) if y0 is None else y0.broadcast_to(batch + (m,))
    eye = torch.eye(n, **new)

    def run_stage(x, z, y, rho_scale, iters):
        """``iters`` ADMM iterations at a fixed per-lane rho (refactored)."""
        rho_vec = base_rho * rho_scale[..., None]                  # (batch, m)
        kkt = (P + sigma * eye + A.transpose(-1, -2) @ (rho_vec[..., None] * A)
               ).broadcast_to(batch + (n, n))
        chol = cholesky_nan(kkt)
        if kkt_inverse:
            Kinv = torch.cholesky_solve(eye.expand(batch + (n, n)), chol)

            def kkt_solve(rhs):
                x1 = _mv(Kinv, rhs)
                for _ in range(kkt_refine):
                    x1 = x1 + _mv(Kinv, rhs - _mv(kkt, x1))
                return x1
        else:
            def kkt_solve(rhs):
                return torch.cholesky_solve(rhs[..., None], chol)[..., 0]

        for _ in range(iters):
            rhs = sigma * x - q + _mtv(A, rho_vec * z - y)
            x_tilde = kkt_solve(rhs)
            x = alpha * x_tilde + (1 - alpha) * x
            z_relaxed = alpha * _mv(A, x_tilde) + (1 - alpha) * z
            z_next = _clip(z_relaxed + y / rho_vec, l, u)
            y = y + rho_vec * (z_relaxed - z_next)
            z = z_next
        return x, z, y

    check_every = max(1, min(check_every, iterations))
    n_stages = max(1, -(-iterations // check_every))

    if s0 is None:
        rho_scale = torch.ones(batch, **new)
    else:
        s0 = torch.as_tensor(s0, **new)
        if s0.dim() and s0.shape[-1] == 1 and s0.dim() > len(batch):
            s0 = s0[..., 0]
        rho_scale = s0.broadcast_to(batch)
    for _ in range(n_stages):
        x, z, y = run_stage(x, z, y, rho_scale, check_every)
        # OSQP adaptive rho: balance relative primal vs dual residuals per lane
        rp, rd = _relative_residuals(P, q, A, x, z, y)
        scale = torch.sqrt(rp / torch.clamp(rd, min=1e-12))
        rho_scale = torch.clamp(rho_scale * torch.clamp(scale, 0.2, 5.0), 1e-6, 1e6)

    cand = _diagnose(P_orig, q_orig, A_orig, D, E, c, x, z, y)
    if polish_iters > 0:
        # rho-continuation dual polish: the KKT point is a fixed point for
        # EVERY rho, so on converged lanes a short low-rho stage only refines
        # the duals' settling granularity; on lanes NOT yet converged it can
        # blow the residual up, hence the per-lane acceptance
        pol = _diagnose(P_orig, q_orig, A_orig, D, E, c, *run_stage(
            x, z, y, torch.clamp(rho_scale * polish_scale, 1e-6, 1e6), polish_iters))
        cand = _pick_polished(cand, pol, eps_abs, eps_rel)
    return _solution(cand, P_orig, q_orig, eps_abs, eps_rel,
                     rho_scale[..., None], None)


@torch.no_grad()
@f32_matmuls
def solve_qp_lanes(
    P: torch.Tensor,
    q: torch.Tensor,
    A: torch.Tensor,
    l: torch.Tensor,
    u: torch.Tensor,
    *,
    iterations: int = 200,
    rho: float = 1.0,
    sigma: float = 1e-6,
    alpha: float = 1.6,
    eps_abs: float = 1e-5,
    eps_rel: float = 1e-5,
    rho_eq_scale: Optional[float] = None,
    scaling_iters: int = 10,
    check_every: int = 25,
    x0: Optional[torch.Tensor] = None,
    y0: Optional[torch.Tensor] = None,
    s0: Optional[torch.Tensor] = None,
    polish_iters: int = 0,
    polish_scale: float = 0.1,
    s_min: float = 1e-4,
    s_max: float = 1e4,
) -> QPSolution:
    """Fused-kernel ADMM for a batch of QPs with PER-LANE (P, A).

    The whole-body-QP shape of the control stack: every lane carries its own
    cost and constraint matrices (its own mass matrix and Jacobians), so the
    shared-factor spectral path is unavailable. This path:

    - Ruiz-equilibrates per lane (same as :func:`solve_qp`);
    - per stage, builds ``K(s) = P_s + sigma I + s A_s' rho A_s`` (a batched
      matrix product) and inverts it with
      :func:`blf_tpu_torch.ops.cuda.linalg.cholesky_inverse_lane`;
    - runs the stage's iterations fused, with the lane's operators resident on
      the SM (:func:`blf_tpu_torch.ops.cuda.admm_lane.admm_lane_stage`,
      v-space recursion: the sigma x proximal term is dropped exactly as in
      :func:`solve_qp_factored`, shifting the fixed point by ~sigma |x|);
    - adapts the per-lane multiplier ``s`` at stage boundaries by the OSQP
      rule with x5 hysteresis, ``s`` in ``[s_min, s_max]`` (a warm ``s0`` is
      taken as it is, unclipped), and accepts an optional dual polish per lane
      only where it improves the tolerance-normalized residual score.

    Semantics, warm starts and diagnostics mirror :func:`solve_qp`;
    ``converged`` and the residuals are computed in the ORIGINAL scaling.
    Exactly one leading batch axis is required. On CPU tensors the two
    kernels' plain versions run; on CUDA tensors (float32) the kernels are
    launched, twice a stage, or the call raises. ``QPSolution.refined`` is
    False. Any number of stages is taken: the reference's guard against more
    than 64 is a compile-time concern of its unrolled trace.
    """
    n, m = P.shape[-1], A.shape[-2]
    dtype, device = P.dtype, P.device
    if rho_eq_scale is None:
        rho_eq_scale = _default_rho_eq_scale(dtype)
    batch = torch.broadcast_shapes(
        P.shape[:-2], q.shape[:-1], A.shape[:-2], l.shape[:-1], u.shape[:-1],
        () if x0 is None else x0.shape[:-1],
        () if y0 is None else y0.shape[:-1])
    if len(batch) != 1:
        raise ValueError(
            f"solve_qp_lanes requires exactly one batch axis, got {tuple(batch)}")
    B = batch[0]
    new = dict(dtype=dtype, device=device)
    P = P.broadcast_to((B, n, n))
    A = A.broadcast_to((B, m, n))
    q = q.broadcast_to((B, n))
    l = l.broadcast_to((B, m))
    u = u.broadcast_to((B, m))

    P_orig, q_orig, A_orig = P, q, A
    P, q, A, D, E, c = _ruiz_lanes(P, q, A, scaling_iters)
    l = (E * l).contiguous()
    u = (E * u).contiguous()
    A = A.contiguous()
    q = q.contiguous()

    is_eq = (u - l) < 1e-12
    one = torch.ones((), dtype=dtype, device=device)
    base_rho = torch.where(is_eq, one * (rho * rho_eq_scale), one * rho)

    # -- v-space init ----------------------------------------------------------
    if x0 is None:
        x = torch.zeros((B, n), **new)
    else:
        x = (x0 / D).broadcast_to((B, n))
    z = _mv(A, x)
    y = torch.zeros((B, m), **new) if y0 is None else (c[..., None] * y0 / E)
    if s0 is None:
        s = torch.ones((B, 1), **new)
    else:
        s = torch.as_tensor(s0, **new)
        s = s.reshape(B, -1)[:, :1] if s.dim() else s.expand(B, 1)
    v = z + y / (s * base_rho)
    eye = torch.eye(n, **new)
    At = A.transpose(-1, -2)

    def run_stage(v, s, iters):
        rho_lane = (s * base_rho).contiguous()                     # (B, m)
        K = P + sigma * eye + At @ (rho_lane[..., None] * A)
        Kinv = cholesky_inverse_lane(K.contiguous())
        return admm_lane_stage(v.contiguous(), rho_lane, A, Kinv, q, l, u,
                               iters=iters, alpha=alpha)           # (B, m), (B, n)

    check_every = max(1, min(check_every, iterations))
    n_stages = max(1, -(-iterations // check_every))

    for _ in range(n_stages):
        v, x = run_stage(v, s, check_every)
        z = _clip(v, l, u)
        y = (s * base_rho) * (v - z)
        rp, rd = _relative_residuals(P, q, A, x, z, y)
        ratio = torch.sqrt(rp / torch.clamp(rd, min=1e-12))[..., None]
        move = (ratio > 5.0) | (ratio < 0.2)
        s_new = torch.where(move, torch.clamp(s * ratio, s_min, s_max), s)
        v = z + (s / s_new) * (v - z)
        s = s_new

    def finish(v, x, rho_lane):
        z = _clip(v, l, u)
        return _diagnose(P_orig, q_orig, A_orig, D, E, c, x, z, rho_lane * (v - z))

    cand = finish(v, x, s * base_rho)
    if polish_iters > 0:
        # rho-continuation dual polish, per-lane acceptance (see solve_qp)
        s_pol = torch.clamp(s * polish_scale, s_min, s_max)
        z = _clip(v, l, u)
        v_p = z + (s / s_pol) * (v - z)
        v_p, x_p = run_stage(v_p, s_pol, polish_iters)
        cand = _pick_polished(cand, finish(v_p, x_p, s_pol * base_rho),
                              eps_abs, eps_rel)
    return _solution(cand, P_orig, q_orig, eps_abs, eps_rel, s,
                     torch.zeros((), dtype=torch.bool, device=device))
