"""Convex hulls -> half-space constraints ``A x <= b``, host and batched paths.

Counterpart of ``blf_tpu/planners/convex_hull.py``; everything of it is
ported. Re-design of the reference's ``ConvexHullHelper``
(``src/Planners/src/ConvexHullHelper.cpp``), which wraps Qhull to turn
support-polygon vertices into ZMP half-space constraints and test
membership. Two paths:

- **Host** :func:`halfspaces_from_points`: exact V-rep -> H-rep in any
  dimension through scipy's Qhull binding (imported at the call, as the
  reference does), numpy in and out.
- **Batched** :func:`monotone_chain_2d`: a fixed-size 2-D Andrew monotone
  chain in torch ops over a leading batch axis (the reference ``vmap``s its
  one-polygon form over knots), padded to ``2K`` vertices with no
  data-dependent shapes and no host synchronisation; plus
  :func:`halfspaces_from_polygon` and :func:`point_in_halfspaces`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from blf_tpu_torch.utils.device import DeviceLike, resolve_device

__all__ = [
    "halfspaces_from_points",
    "point_in_halfspaces",
    "monotone_chain_2d",
    "halfspaces_from_polygon",
    "Polygon2D",
]


def halfspaces_from_points(points: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Convex hull of ``points`` -> ``(A, b)`` with hull = ``{x : A x <= b}``.

    Equivalent of ``ConvexHullHelper::buildConvexHull``
    (``ConvexHullHelper.cpp:35-89``): facet hyperplanes with unit outward
    normals ``V`` and offsets, ``A = V``, ``b = -offset``. ``points`` is
    ``(n, d)``, any ``d >= 2`` (the reference takes ``d x n``; row-major here).
    """
    from scipy.spatial import ConvexHull  # Qhull, as in the reference

    points = np.asarray(points, dtype=np.float64)
    hull = ConvexHull(points)
    # scipy equations: A x + b0 <= 0 with unit normals
    A = hull.equations[:, :-1]
    b = -hull.equations[:, -1]
    return A, b


def point_in_halfspaces(A, b, point, tol: Optional[float] = None, *,
                        device: DeviceLike = None) -> torch.Tensor:
    """Batched membership ``A p <= b (+tol)``
    (``ConvexHullHelper::doesPointBelongToConvexHull``,
    ``ConvexHullHelper.cpp:101-117``). Broadcasts over leading axes of
    ``point``; returns a bool tensor. The arrays (numpy ones too) are taken
    as tensors on ``device`` if it is given, else on the device of the first
    tensor among ``A``, ``point``, ``b``; where none is a tensor,
    ``device=None`` means the GPU and raises without one (pass
    ``device="cpu"`` to run on the CPU).

    ``tol=None`` (default) uses a dtype-scaled slack
    ``64 eps (1 + max|b|)`` so hull *vertices* stay members under the working
    precision.
    """
    like = next((t for t in (A, point, b) if torch.is_tensor(t)), None)
    if device is not None or like is None:
        device = resolve_device(device)
    else:
        device = like.device
    A, b, point = (torch.as_tensor(t, device=device) for t in (A, b, point))
    dtype = torch.promote_types(torch.promote_types(A.dtype, b.dtype), point.dtype)
    A, b, point = A.to(dtype), b.to(dtype), point.to(dtype)
    if tol is None:
        tol = 64.0 * torch.finfo(dtype).eps * (1.0 + b.abs().max())
    margins = torch.einsum("...fd,...d->...f", A, point) - b
    return (margins <= tol).all(dim=-1)


class Polygon2D(NamedTuple):
    """Fixed-size padded 2-D convex polygon: CCW ``vertices`` with only the
    first ``count`` valid (padding repeats the last valid vertex)."""

    vertices: torch.Tensor  # (..., 2K, 2)
    count: torch.Tensor     # (...,) int64


def _cross(o, a, b):
    return (a[..., 0] - o[..., 0]) * (b[..., 1] - o[..., 1]) - (
        a[..., 1] - o[..., 1]) * (b[..., 0] - o[..., 0])


def _take(x, idx):
    """``x[..., idx[...], :]``: one row of ``x`` (..., R, 2) per batch entry."""
    return torch.gather(x, -2, idx[..., None, None].expand(idx.shape + (1, 2)))[..., 0, :]


def _half_hull(pts, valid, reverse: bool):
    """One monotone-chain pass over the sorted points (backwards if
    ``reverse``), skipping padding; returns the hull (..., K+1, 2) and its
    length. A point pops at most all the hull built before it, so ``i`` pops
    bound step ``i`` and the pass needs no data-dependent loop."""
    K = pts.shape[-2]
    hull = torch.zeros(pts.shape[:-2] + (K + 1, 2), dtype=pts.dtype, device=pts.device)
    hlen = torch.zeros(pts.shape[:-2], dtype=torch.int64, device=pts.device)
    slots = torch.arange(K + 1, device=pts.device)
    for i in range(K):
        j = K - 1 - i if reverse else i
        p, ok = pts[..., j, :], valid[..., j]
        for _ in range(i):
            a = _take(hull, (hlen - 2).clamp(min=0))
            b = _take(hull, (hlen - 1).clamp(min=0))
            hlen = hlen - (ok & (hlen >= 2) & (_cross(a, b, p) <= 0.0)).long()
        put = ok[..., None] & (slots == hlen[..., None])
        hull = torch.where(put[..., None], p[..., None, :], hull)
        hlen = hlen + ok.long()
    return hull, hlen


def monotone_chain_2d(points: torch.Tensor, valid: Optional[torch.Tensor] = None) -> Polygon2D:
    """2-D convex hull (Andrew monotone chain) with static shapes.

    ``points`` is ``(..., K, 2)``; ``valid`` an optional ``(..., K)`` bool mask
    of real points (padding allowed). Returns the hull as a
    :class:`Polygon2D` with at most ``K`` CCW vertices, padded to ``2K``
    (the reference's layout). Collinear points are dropped; with two valid
    points or fewer the hull is the valid points themselves.
    """
    K = points.shape[-2]
    if valid is None:
        valid = torch.ones(points.shape[:-1], dtype=torch.bool, device=points.device)
    big = torch.finfo(points.dtype).max
    # sort lexicographically by (x, y), invalid points to the end: a stable
    # sort by y, then a stable sort by x
    x_key = torch.where(valid, points[..., 0], big)
    y_key = torch.where(valid, points[..., 1], big)
    by_y = torch.sort(y_key, dim=-1, stable=True).indices
    by_x = torch.sort(torch.gather(x_key, -1, by_y), dim=-1, stable=True).indices
    order = torch.gather(by_y, -1, by_x)
    pts = torch.gather(points, -2, order[..., None].expand(order.shape + (2,)))
    valid_sorted = torch.gather(valid, -1, order)
    n = valid.sum(dim=-1)

    lower_hull, lower_len = _half_hull(pts, valid_sorted, reverse=False)
    upper_hull, upper_len = _half_hull(pts, valid_sorted, reverse=True)

    # CCW hull = lower[:-1] ++ upper[:-1] (each pass ends on the other's start).
    idx = torch.arange(2 * K, device=points.device)
    lo, up = lower_len[..., None], upper_len[..., None]
    in_lower = idx < lo - 1
    in_upper = (idx >= lo - 1) & (idx < lo + up - 2)
    low_take = idx.clamp(0, K).expand(in_lower.shape)
    up_take = (idx - (lo - 1)).clamp(0, K)
    gather2 = lambda h, t: torch.gather(h, -2, t[..., None].expand(t.shape + (2,)))
    out = torch.where(in_lower[..., None], gather2(lower_hull, low_take),
                      torch.where(in_upper[..., None], gather2(upper_hull, up_take),
                                  torch.zeros((), dtype=points.dtype, device=points.device)))
    count = (lower_len + upper_len - 2).clamp(min=0)

    # Degenerate inputs (n <= 2): the hull is just the valid points.
    degen = n <= 2
    count = torch.where(degen, n, count)
    out = torch.where(degen[..., None, None], torch.cat([pts, pts], dim=-2), out)
    # Pad by repeating the last valid vertex.
    last = _take(out, (count - 1).clamp(min=0))
    out = torch.where((idx < count[..., None])[..., None], out, last[..., None, :])
    return Polygon2D(vertices=out, count=count)


def halfspaces_from_polygon(poly: Polygon2D, tol: float = 1e-12):
    """CCW padded polygon -> padded ``(A, b)`` with outward unit normals.

    Edge ``v_i -> v_{i+1}`` yields normal ``(e_y, -e_x)/|e|``; padded edges
    (zero length) produce the always-true constraint ``0 x <= 1`` so
    downstream ``A x <= b`` checks need no masking.
    """
    v = poly.vertices
    K = v.shape[-2]
    idx = torch.arange(K, device=v.device)
    count = poly.count[..., None]
    nxt = torch.where(idx + 1 < count, idx + 1, 0)
    v_next = torch.gather(v, -2, nxt[..., None].expand(nxt.shape + (2,)))
    e = v_next - v
    norm = torch.sqrt((e * e).sum(dim=-1, keepdim=True))
    good = (norm[..., 0] > tol) & (idx < count)
    n_hat = torch.where(good[..., None],
                        torch.stack([e[..., 1], -e[..., 0]], dim=-1) / norm.clamp(min=tol),
                        torch.zeros((), dtype=v.dtype, device=v.device))
    b = torch.where(good, (n_hat * v).sum(dim=-1),
                    torch.ones((), dtype=v.dtype, device=v.device))
    return n_hat, b
