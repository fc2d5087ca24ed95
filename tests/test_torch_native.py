"""Port parity of the native host runtime (``blf_tpu_torch/native``).

The port's own ``schedule.cpp``, built with ``g++`` into
``blf_tpu_torch/_build/``, against the port's numpy versions and against
``blf_tpu.native`` on the same inputs: schedules exactly, hulls and
half-spaces to 1e-12. Tests that need the library skip only where no C++
compiler is found, as ``tests/test_native.py`` does.
"""

import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from blf_tpu import native as jnative
from blf_tpu_torch import native
from blf_tpu_torch.planners.contacts import ContactList, lower_contact_schedule
from blf_tpu_torch.planners.gait import footstep_plan, support_polygons
from test_native import random_schedules

# One intra-op thread: the tensors here are small, and test workers running side
# by side would each start a thread per core and slow every other worker down.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def lib():
    if shutil.which("g++") is None:
        pytest.skip("no C++ toolchain available")
    assert native.available(), native.available().reason
    native.reset_counts()


def test_schedules_native_equal_the_numpy_version_and_the_reference(lib):
    act, deact, cnt, pos, _ = random_schedules(np.random.default_rng(0))
    ours = native.lower_schedules_batch(act, deact, cnt, pos, 40, 0.1)
    numpy_path = native.lower_schedules_batch(act, deact, cnt, pos, 40, 0.1, force_python=True)
    theirs = jnative.lower_schedules_batch(act, deact, cnt, pos, 40, 0.1)
    for a, b, c in zip(ours, numpy_path, theirs):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert native.native_count() == 1 and native.python_count() == 1


def test_schedules_match_the_planners_layer(lib):
    act, deact, cnt, pos, lists = random_schedules(np.random.default_rng(1), B=8)
    a, i, p = native.lower_schedules_batch(act, deact, cnt, pos, 30, 0.1)
    for b in range(8):
        port_lists = {}
        for name, lst in lists[b].items():
            port_lists[name] = ContactList(default_name=name)
            for c in lst:
                assert port_lists[name].add_contact(position=c.position,
                                                    activation_time=c.activation_time,
                                                    deactivation_time=c.deactivation_time)
        sched = lower_contact_schedule(port_lists, dt=0.1, horizon=30)
        for e, name in enumerate(sched.names):
            np.testing.assert_array_equal(a[b, e], sched.active[e], err_msg=f"{b} {name}")
            np.testing.assert_array_equal(i[b, e], sched.contact_index[e])
            np.testing.assert_array_equal(p[b, e], sched.position[e])


@pytest.mark.parametrize("n", [3, 8, 50])
def test_hull_matches_scipy_and_the_reference(lib, n):
    from scipy.spatial import ConvexHull

    pts = np.random.default_rng(4 + n).uniform(-1, 1, (n, 2))
    ours = native.monotone_chain(pts)
    np.testing.assert_allclose(ours, jnative.monotone_chain(pts), atol=1e-12, rtol=0)
    ref = pts[ConvexHull(pts).vertices]
    assert len(ours) == len(ref)
    start = np.argmin(np.linalg.norm(ref - ours[0], axis=1))
    np.testing.assert_allclose(ours, np.roll(ref, -start, axis=0), atol=1e-12)


def test_degenerate_hulls(lib):
    assert len(native.monotone_chain(np.array([[0.0, 0.0], [1.0, 1.0]]))) == 2
    assert len(native.monotone_chain(np.array([[0.0, 0.0], [0.5, 0.5], [1.0, 1.0]]))) == 2
    assert native.monotone_chain(np.zeros((0, 2))).shape == (0, 2)


def test_support_polygons_native_numpy_and_reference_agree(lib):
    rng = np.random.default_rng(5)
    B, E, T = 6, 2, 15
    active = rng.random((B, E, T)) > 0.3
    active[:, 0, 0] = True
    active[2, :, 4] = False          # a flight knot: the previous polygon carries on
    foot_xy = rng.normal(size=(B, E, T, 2)) * 0.2
    A1, b1 = native.support_polygons_batch(active, foot_xy, 0.07, 0.04)
    A2, b2 = native.support_polygons_batch(active, foot_xy, 0.07, 0.04, force_python=True)
    A3, b3 = jnative.support_polygons_batch(active, foot_xy, 0.07, 0.04)
    for A, b in ((A2, b2), (A3, b3)):
        np.testing.assert_allclose(A1, A, atol=1e-12, rtol=0)
        np.testing.assert_allclose(b1, b, atol=1e-12, rtol=0)
    np.testing.assert_array_equal(A1[2, 4], A1[2, 3])


def test_native_polygons_equal_the_gaits(lib):
    """The 10-step gait through the batch functions equals the planners'
    schedule and their batched torch hulls (float64) to 1e-12."""
    lists = footstep_plan(num_steps=10, step_length=0.15)
    names = sorted(lists)
    C = max(len(lists[k]) for k in names)
    act, deact = np.zeros((1, 2, C)), np.zeros((1, 2, C))
    cnt, pos = np.zeros((1, 2), np.int32), np.zeros((1, 2, C, 3))
    for e, name in enumerate(names):
        for c, contact in enumerate(lists[name]):
            act[0, e, c], deact[0, e, c] = contact.activation_time, contact.deactivation_time
            pos[0, e, c] = contact.position
        cnt[0, e] = len(lists[name])
    a, i, p = native.lower_schedules_batch(act, deact, cnt, pos, 96, 0.1)
    sched = lower_contact_schedule(lists, dt=0.1, horizon=96)
    np.testing.assert_array_equal(a[0], sched.active)
    np.testing.assert_array_equal(i[0], sched.contact_index)
    A, b = native.support_polygons_batch(a, p[..., :2], 0.07, 0.04)
    At, bt = support_polygons(sched, device="cpu", dtype=torch.float64)
    np.testing.assert_allclose(A[0], At.numpy(), atol=1e-12, rtol=0)
    np.testing.assert_allclose(b[0], bt.numpy(), atol=1e-12, rtol=0)
    assert native.python_count() == 0


def test_the_library_lives_in_the_ports_build_directory():
    path = Path(native.library_path())
    assert path.parent == ROOT / "blf_tpu_torch" / "_build"
    assert path.name.startswith("libblf_native_") and path.suffix == ".so"


def test_a_failed_build_says_why_and_every_numpy_run_is_counted(monkeypatch, tmp_path):
    """Where g++ fails, ``available()`` is falsy and carries the compiler's
    output; the functions then run their numpy versions, each one counted."""
    monkeypatch.setattr(native, "_SRC", str(tmp_path / "broken.cpp"))
    (tmp_path / "broken.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_REASON", None)
    native.reset_counts()
    status = native.available()
    assert not status and "broken.cpp" in status.reason
    assert "g++" in status.reason
    act, deact, cnt, pos, _ = random_schedules(np.random.default_rng(3), B=4)
    a, _, _ = native.lower_schedules_batch(act, deact, cnt, pos, 20, 0.1)
    assert a.shape == (4, 2, 20) and native.python_count() == 1
    assert native.native_count() == 0 and not list((tmp_path / "build").glob("*.so"))
