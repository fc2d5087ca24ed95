"""Port parity of the contact timeline (``blf_tpu_torch/planners/contacts.py``).

Every case of ``tests/test_contacts_plan.py`` (ContactListTest.cpp and
ContactPhaseListTest.cpp of the reference, section by section) runs on the
port's copy, and ``lower_contact_schedule`` is held to ``blf_tpu``'s on the
same lists, exactly (both are numpy on the host).
"""

import numpy as np
import pytest
import torch

from blf_tpu.planners import contacts as jc
from blf_tpu_torch.planners import contacts as tc
from blf_tpu_torch.planners.contacts import (
    Contact,
    ContactList,
    ContactPhaseList,
    ContactType,
    lower_contact_schedule,
)

# One intra-op thread: the tensors here are small, and test workers running side
# by side would each start a thread per core and slow every other worker down.
torch.set_num_threads(1)


@pytest.fixture
def two_contact_list():
    # ContactListTest.cpp:30-40
    lst = ContactList()
    p1 = Contact(activation_time=0.1, deactivation_time=0.5)
    p2 = Contact(activation_time=1.0, deactivation_time=1.5)
    assert lst.add_contact(p2)
    assert lst.add_contact(p1)
    return lst, p1, p2


class TestContactList:
    def test_insertion_order(self, two_contact_list):
        # ContactListTest.cpp:48-62
        lst, p1, p2 = two_contact_list
        assert lst.first_contact() == p1
        assert lst.last_contact() == p2
        p3 = Contact(activation_time=0.6, deactivation_time=0.8)
        assert lst.add_contact(p3)
        assert len(lst) == 3
        assert lst[1] == p3

    def test_size(self, two_contact_list):
        lst, *_ = two_contact_list
        assert len(lst) == 2

    def test_invalid_insertion(self, two_contact_list):
        # ContactListTest.cpp:69-76: [0.9, 1.6] overlaps [1.0, 1.5]
        lst, *_ = two_contact_list
        assert not lst.add_contact(Contact(activation_time=0.9, deactivation_time=1.6))

    def test_activation_after_deactivation_rejected(self):
        # ContactList.cpp:42-46
        lst = ContactList()
        assert not lst.add_contact(Contact(activation_time=1.0, deactivation_time=0.5))

    def test_touching_windows_rejected(self):
        # comparator semantics (ContactList.cpp:15-18): deactivation must be
        # strictly before the next activation
        lst = ContactList()
        assert lst.add_contact(Contact(activation_time=0.0, deactivation_time=1.0))
        assert not lst.add_contact(Contact(activation_time=1.0, deactivation_time=2.0))

    def test_edit(self, two_contact_list):
        # ContactListTest.cpp:78-86
        lst, p1, p2 = two_contact_list
        p2_mod = Contact(
            activation_time=p2.activation_time,
            deactivation_time=p2.deactivation_time,
            type=ContactType.POINT,
        )
        assert lst.edit_contact(len(lst) - 1, p2_mod)
        assert lst.last_contact() == p2_mod

    def test_edit_rejects_overlap_with_neighbors(self, two_contact_list):
        lst, p1, p2 = two_contact_list
        bad = Contact(activation_time=0.4, deactivation_time=1.5)  # into p1
        assert not lst.edit_contact(1, bad)

    def test_present_step(self, two_contact_list):
        # ContactListTest.cpp:88-96
        lst, p1, p2 = two_contact_list
        assert lst[lst.get_present_contact(1.2)] == p2
        assert lst[lst.get_present_contact(1.6)] == p2
        assert lst[lst.get_present_contact(0.6)] == p1
        assert lst.get_present_contact(0.0) is None

    def test_keep_present_and_clear(self, two_contact_list):
        # ContactListTest.cpp:98-102 + keepOnlyPresentContact semantics
        lst, p1, p2 = two_contact_list
        assert lst.keep_only_present_contact(0.6)
        assert len(lst) == 1 and lst[0] == p1
        lst.clear()
        assert len(lst) == 0

    def test_accessor_50_contacts(self, two_contact_list):
        # ContactListTest.cpp:104-122
        lst, *_ = two_contact_list
        for i in range(49):
            assert lst.add_contact(
                activation_time=2.0 + i, deactivation_time=2.5 + i
            )
        assert len(lst) == 51
        for i, c in enumerate(lst):
            assert lst[i] == c


def build_reference_lists():
    # ContactPhaseListTest.cpp:36-50
    left = ContactList(default_name="left")
    right = ContactList(default_name="right")
    additional = ContactList(default_name="additional")
    assert left.add_contact(activation_time=0.0, deactivation_time=1.0)
    assert left.add_contact(activation_time=2.0, deactivation_time=5.0)
    assert left.add_contact(activation_time=6.0, deactivation_time=7.0)
    assert right.add_contact(activation_time=0.0, deactivation_time=3.0)
    assert right.add_contact(activation_time=4.0, deactivation_time=7.0)
    assert additional.add_contact(activation_time=4.0, deactivation_time=5.0)
    assert additional.add_contact(activation_time=6.0, deactivation_time=7.5)
    return left, right, additional


class TestContactPhaseList:
    def test_set_from_map(self):
        # ContactPhaseListTest.cpp:20-34
        left = ContactList(default_name="left")
        right = ContactList(default_name="right")
        for a, d in [(0.0, 1.0), (2.0, 5.0), (6.0, 7.0)]:
            assert left.add_contact(activation_time=a, deactivation_time=d)
        for a, d in [(0.0, 3.0), (4.0, 7.0)]:
            assert right.add_contact(activation_time=a, deactivation_time=d)
        pl = ContactPhaseList()
        assert pl.set_lists({"left": left, "right": right})
        assert len(pl) > 0

    def test_duplicate_names_rejected(self):
        # ContactPhaseList.cpp:98-105
        a = ContactList(default_name="same")
        b = ContactList(default_name="same")
        pl = ContactPhaseList()
        assert not pl.set_lists([a, b])

    def test_check_phases(self):
        """ContactPhaseListTest.cpp:52-151 — all 8 phases, boundary by boundary."""
        left, right, additional = build_reference_lists()
        pl = ContactPhaseList()
        assert pl.set_lists([additional, left, right])
        assert len(pl) == 8

        expected = [
            (0.0, 1.0, {"left": 0, "right": 0}),
            (1.0, 2.0, {"right": 0}),
            (2.0, 3.0, {"left": 1, "right": 0}),
            (3.0, 4.0, {"left": 1}),
            (4.0, 5.0, {"left": 1, "right": 1, "additional": 0}),
            (5.0, 6.0, {"right": 1}),
            (6.0, 7.0, {"left": 2, "right": 1, "additional": 1}),
            (7.0, 7.5, {"additional": 1}),
        ]
        for phase, (begin, end, active) in zip(pl, expected):
            assert phase.begin_time == begin
            assert phase.end_time == end
            assert phase.active_contacts == active

        assert pl.first_phase().begin_time == 0.0
        assert pl.last_phase().end_time == 7.5
        assert pl[4].is_list_included("additional")
        assert not pl[1].is_list_included("left")


class TestLowering:
    def test_dense_masks_match_phases(self):
        left, right, additional = build_reference_lists()
        pl = ContactPhaseList()
        pl.set_lists([additional, left, right])
        dt = 0.25
        arrays = lower_contact_schedule(pl.lists(), dt=dt, horizon=32)

        assert arrays.names == ("additional", "left", "right")
        e = {n: i for i, n in enumerate(arrays.names)}
        # cross-check every knot against the phase list semantics
        for k, t in enumerate(arrays.times):
            for name, lst in pl.lists().items():
                idx = lst.get_present_contact(t)
                expected_active = idx is not None and t < lst[idx].deactivation_time
                assert arrays.active[e[name], k] == expected_active, (name, t)
                if idx is not None:
                    assert arrays.contact_index[e[name], k] == idx

    def test_foothold_poses(self):
        lst = ContactList(default_name="foot")
        lst.add_contact(position=np.array([0.0, 0.1, 0.0]),
                        activation_time=0.0, deactivation_time=0.4)
        lst.add_contact(position=np.array([0.3, -0.1, 0.0]),
                        activation_time=0.6, deactivation_time=1.0)
        arrays = lower_contact_schedule({"foot": lst}, dt=0.1, horizon=10)
        np.testing.assert_array_equal(arrays.position[0, 0], [0.0, 0.1, 0.0])
        # during the swing (0.4-0.6) the pose is the present (previous) contact
        np.testing.assert_array_equal(arrays.position[0, 5], [0.0, 0.1, 0.0])
        assert not arrays.active[0, 5]
        np.testing.assert_array_equal(arrays.position[0, 7], [0.3, -0.1, 0.0])
        assert arrays.active[0, 7]


def random_lists(module, rng, names=("left", "right", "tool")):
    """Random non-overlapping windows per list, built in ``module``."""
    lists = {}
    for name in names:
        lst = module.ContactList(default_name=name)
        t = rng.uniform(0.0, 0.5)
        for _ in range(rng.integers(1, 6)):
            dur = rng.uniform(0.1, 0.9)
            p = rng.normal(size=3)
            R = np.linalg.qr(rng.normal(size=(3, 3)))[0]
            assert lst.add_contact(position=p, rotation=R, activation_time=t,
                                   deactivation_time=t + dur)
            t += dur + rng.uniform(0.01, 0.4)
        lists[name] = lst
    return lists


@pytest.mark.parametrize("seed", range(6))
def test_lowering_equals_the_reference(seed):
    """Same windows in both packages -> the same dense arrays, exactly, and
    the same phase segmentation."""
    ours = random_lists(tc, np.random.default_rng(seed))
    theirs = random_lists(jc, np.random.default_rng(seed))
    dt, T, t0 = 0.05 + 0.05 * (seed % 2), 60, 0.1 * seed
    a = lower_contact_schedule(ours, dt=dt, horizon=T, t0=t0)
    b = jc.lower_contact_schedule(theirs, dt=dt, horizon=T, t0=t0)
    assert a.names == b.names
    for field in ("times", "active", "position", "rotation", "contact_index"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field), err_msg=field)
    pa, pb = ContactPhaseList(), jc.ContactPhaseList()
    assert pa.set_lists(ours) and pb.set_lists(theirs)
    assert [(p.begin_time, p.end_time, p.active_contacts) for p in pa] == \
        [(p.begin_time, p.end_time, p.active_contacts) for p in pb]


def test_same_rejections_as_the_reference():
    """Touching, overlapping and inverted windows are rejected alike."""
    windows = [(0.0, 1.0), (1.0, 2.0), (0.5, 0.7), (2.5, 2.0), (1.2, 1.3), (1.3, 1.4)]
    ours, theirs = ContactList(), jc.ContactList()
    got = [ours.add_contact(activation_time=a, deactivation_time=d) for a, d in windows]
    want = [theirs.add_contact(activation_time=a, deactivation_time=d) for a, d in windows]
    assert got == want == [True, False, False, False, True, False]
