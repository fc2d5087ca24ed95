"""Port parity of the convex hulls (``blf_tpu_torch/planners/convex_hull.py``).

The batched torch monotone chain and its half-spaces against
``blf_tpu.planners.convex_hull`` on JAX-CPU (``vmap``ped over the same
batch), on random masked point sets, collinear and degenerate sets; the host
path (scipy's Qhull) in 2 and 3 dimensions; membership. Float64 throughout:
vertices, counts and the padding equal the reference's exactly, normals and
offsets to 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blf_tpu.planners import convex_hull as jch
from blf_tpu_torch.planners import convex_hull as tch
from test_convex_hull import PRISM_POINTS

# One intra-op thread: the tensors here are small, and test workers running side
# by side would each start a thread per core and slow every other worker down.
torch.set_num_threads(1)


@jax.jit
def reference_hulls(points, valid):
    poly = jax.vmap(jch.monotone_chain_2d)(points, valid)
    return poly, jax.vmap(jch.halfspaces_from_polygon)(poly)


def assert_same_hulls(points, valid):
    (jpoly, (jA, jb)) = reference_hulls(jnp.asarray(points), jnp.asarray(valid))
    tpoly = tch.monotone_chain_2d(torch.as_tensor(points), torch.as_tensor(valid))
    tA, tb = tch.halfspaces_from_polygon(tpoly)
    np.testing.assert_array_equal(tpoly.count.numpy(), np.asarray(jpoly.count))
    np.testing.assert_array_equal(tpoly.vertices.numpy(), np.asarray(jpoly.vertices))
    np.testing.assert_allclose(tA.numpy(), np.asarray(jA), atol=1e-12, rtol=0)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-12, rtol=0)
    return tpoly


@pytest.mark.parametrize("K", [3, 8, 12])
def test_random_masked_sets_match_the_reference(K):
    rng = np.random.default_rng(K)
    points = rng.uniform(-1, 1, (64, K, 2))
    valid = rng.random((64, K)) > 0.3
    valid[0] = True                        # a full set
    valid[1] = False                       # an empty one
    valid[2, 1:] = False                   # one point
    valid[3, 2:] = False                   # two
    points[4, -1] = points[4, 0]           # a duplicate
    assert_same_hulls(points, valid)


def test_collinear_and_lattice_sets_match_the_reference():
    """Points on a grid of 1/2 (many collinear triples and duplicates), a
    whole set on one line, the gait's foot corners."""
    rng = np.random.default_rng(7)
    lattice = np.round(rng.uniform(-1, 1, (32, 8, 2)) * 2) / 2
    # a line with dyadic coordinates: its cross products are exactly 0 in any
    # order of operations (on a line through inexact values a rounded 0
    # decides, and the reference compiled by XLA keeps 7 of 8 points where
    # it keeps 2 run eagerly, as the port does)
    line = np.stack([np.arange(8) / 8, np.arange(8) / 16], -1)[None]
    corners = np.array([[0.07, 0.14], [0.07, 0.06], [-0.07, 0.14], [-0.07, 0.06],
                        [0.07, -0.06], [0.07, -0.14], [-0.07, -0.06], [-0.07, -0.14]])[None]
    points = np.concatenate([lattice, line, corners])
    poly = assert_same_hulls(points, np.ones(points.shape[:2], bool))
    assert int(poly.count[32]) == 2 and int(poly.count[33]) == 4


def test_degenerate_and_collinear_cases_of_the_reference_tests():
    two = tch.monotone_chain_2d(torch.tensor([[0.0, 0.0], [1.0, 1.0]], dtype=torch.float64))
    assert int(two.count) == 2
    one = tch.monotone_chain_2d(torch.tensor([[2.0, 3.0], [0.0, 0.0]], dtype=torch.float64),
                                torch.tensor([True, False]))
    assert int(one.count) == 1 and one.vertices[0].tolist() == [2.0, 3.0]
    collinear = torch.tensor([[0.0, 0.0], [0.5, 0.5], [1.0, 1.0], [1.0, 0.0]],
                             dtype=torch.float64)
    assert int(tch.monotone_chain_2d(collinear).count) == 3


def test_halfspaces_hold_their_points_and_float32_follows():
    rng = np.random.default_rng(11)
    pts = rng.uniform(-1, 1, size=(12, 2))
    for dtype in (torch.float64, torch.float32):
        poly = tch.monotone_chain_2d(torch.as_tensor(pts, dtype=dtype))
        A, b = tch.halfspaces_from_polygon(poly)
        assert A.dtype == dtype
        assert bool(tch.point_in_halfspaces(A, b, torch.as_tensor(pts, dtype=dtype)).all())
        assert not bool(tch.point_in_halfspaces(A, b, torch.tensor([5.0, 0.0], dtype=dtype)))


@pytest.mark.parametrize("points", [PRISM_POINTS, PRISM_POINTS[:4, :2],
                                    np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]])],
                         ids=["prism3d", "rectangle2d", "square2d"])
def test_host_hull_and_membership_match_the_reference(points):
    """Qhull in any dimension (scipy is imported at the call), and membership
    with the dtype-scaled default slack, on the vertices, the centroid and
    the origin."""
    A, b = tch.halfspaces_from_points(points)
    jA, jb = jch.halfspaces_from_points(points)
    np.testing.assert_array_equal(A, jA)
    np.testing.assert_array_equal(b, jb)
    probes = np.vstack([points, points.mean(axis=0), np.zeros(points.shape[1]),
                        points.mean(axis=0) + 2.0])
    ours = tch.point_in_halfspaces(torch.as_tensor(A), torch.as_tensor(b),
                                   torch.as_tensor(probes)).numpy()
    np.testing.assert_array_equal(tch.point_in_halfspaces(A, b, probes, device="cpu").numpy(),
                                  ours)
    theirs = np.asarray(jch.point_in_halfspaces(A, b, jnp.asarray(probes)))
    np.testing.assert_array_equal(ours, theirs)
    assert ours[:-3].all() and ours[-3] and not ours[-1]


def test_membership_of_plain_arrays_follows_the_device_rule(monkeypatch):
    """Numpy inputs carry no device: ``device=None`` then means the GPU and
    raises without one, and the CPU runs only when asked for; a tensor
    argument gives its device."""
    A, b = tch.halfspaces_from_points(PRISM_POINTS[:4, :2])
    probe = PRISM_POINTS[:4, :2].mean(axis=0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device=None"):
        tch.point_in_halfspaces(A, b, probe)
    assert bool(tch.point_in_halfspaces(A, b, probe, device="cpu"))
    assert bool(tch.point_in_halfspaces(A, b, torch.as_tensor(probe)))
