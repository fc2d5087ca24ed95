"""Contact timeline data model + dense array lowering for device kernels.

Counterpart of ``blf_tpu/planners/contacts.py``, copied (the reference is
numpy host code and importing it would load JAX); everything of it is
ported, with the same names, fields and semantics. Host-side re-design of
the reference's ``Contact`` component (SURVEY.md §2 row 8):
``Contact``/``ContactList``/``ContactPhase``/``ContactPhaseList``
(``src/Planners/include/BipedalLocomotion/Planners/{Contact,ContactList,
ContactPhase,ContactPhaseList}.h`` and the matching ``.cpp``):

- a :class:`ContactList` is a time-ordered set of non-overlapping contacts;
  the reference's set comparator ``lhs.deactivationTime < rhs.activationTime``
  (``ContactList.cpp:15-18``) makes any two time-overlapping (or merely
  touching) windows "equivalent" and therefore **rejects** the insertion —
  reproduced exactly;
- :class:`ContactPhaseList` computes the phase segmentation of several lists
  by the same two-event-map sweep (``ContactPhaseList.cpp:16-84``).

Because phase structure is data-dependent, it stays on the host;
:func:`lower_contact_schedule` lowers a schedule to **fixed-shape dense
arrays** (per-knot activation masks + foothold poses, numpy) that batched
device code consumes.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field, replace
from enum import Enum
from typing import Dict, Iterable, List, Mapping, NamedTuple, Optional, Tuple

import numpy as np

__all__ = [
    "ContactType",
    "Contact",
    "ContactList",
    "ContactPhase",
    "ContactPhaseList",
    "ContactScheduleArrays",
    "lower_contact_schedule",
]


class ContactType(Enum):
    """``ContactType`` (``Contact.h:22-33``): FULL = surface patch, POINT."""

    FULL = 0
    POINT = 1


def _identity_pose() -> Tuple[np.ndarray, np.ndarray]:
    return np.zeros(3), np.eye(3)


@dataclass(frozen=True)
class Contact:
    """One contact window (``Contact.h:38-61``): pose + [activation,
    deactivation] times + name + type."""

    position: np.ndarray = field(default_factory=lambda: np.zeros(3))
    rotation: np.ndarray = field(default_factory=lambda: np.eye(3))
    activation_time: float = 0.0
    deactivation_time: float = 0.0
    name: str = "Contact"
    type: ContactType = ContactType.FULL

    def overlaps(self, other: "Contact") -> bool:
        """True iff the set comparator deems the two equivalent
        (``ContactList.cpp:15-18``): neither window strictly precedes the other."""
        return not (
            self.deactivation_time < other.activation_time
            or other.deactivation_time < self.activation_time
        )

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, Contact):
            return NotImplemented
        return (
            self.type == other.type
            and self.name == other.name
            and np.allclose(self.position, other.position)
            and np.allclose(self.rotation, other.rotation)
            and self.activation_time == other.activation_time
            and self.deactivation_time == other.deactivation_time
        )


class ContactList:
    """Time-ordered, non-overlapping list of contacts of one end-effector
    (``ContactList.h:32-210``)."""

    def __init__(self, default_name: str = "Contact",
                 default_type: ContactType = ContactType.FULL):
        self._contacts: List[Contact] = []
        self._default_name = default_name
        self._default_type = default_type

    # -- defaults (ContactList.cpp:20-37) ------------------------------------
    @property
    def default_name(self) -> str:
        return self._default_name

    def set_default_name(self, name: str) -> None:
        self._default_name = name

    @property
    def default_type(self) -> ContactType:
        return self._default_type

    def set_default_type(self, t: ContactType) -> None:
        self._default_type = t

    # -- insertion -----------------------------------------------------------
    def add_contact(
        self,
        contact: Optional[Contact] = None,
        *,
        position=None,
        rotation=None,
        activation_time: Optional[float] = None,
        deactivation_time: Optional[float] = None,
    ) -> bool:
        """Insert preserving order; reject invalid windows and overlaps.

        Mirrors both ``addContact`` overloads (``ContactList.cpp:40-75``):
        returns False (no raise) on rejection, like the reference.
        """
        if contact is None:
            pos, rot = _identity_pose()
            contact = Contact(
                position=np.asarray(position if position is not None else pos, float),
                rotation=np.asarray(rotation if rotation is not None else rot, float),
                activation_time=float(activation_time),
                deactivation_time=float(deactivation_time),
                name=self._default_name,
                type=self._default_type,
            )
        if contact.activation_time > contact.deactivation_time:
            # ContactList.cpp:42-46
            return False
        keys = [c.activation_time for c in self._contacts]
        idx = bisect.bisect_left(keys, contact.activation_time)
        for neighbor in self._contacts[max(0, idx - 1): idx + 1]:
            if neighbor.overlaps(contact):
                return False
        self._contacts.insert(idx, contact)
        return True

    # -- access --------------------------------------------------------------
    def __len__(self) -> int:
        return len(self._contacts)

    def __iter__(self):
        return iter(self._contacts)

    def __getitem__(self, index: int) -> Contact:
        return self._contacts[index]

    def first_contact(self) -> Contact:
        return self._contacts[0]

    def last_contact(self) -> Contact:
        return self._contacts[-1]

    # -- editing (ContactList.cpp:154-188) ------------------------------------
    def edit_contact(self, index: int, new_contact: Contact) -> bool:
        """Replace the contact at ``index`` iff the new window still fits
        between its neighbours."""
        if not 0 <= index < len(self._contacts):
            return False
        if index > 0 and new_contact.activation_time < self._contacts[index - 1].deactivation_time:
            return False
        if (
            index + 1 < len(self._contacts)
            and new_contact.deactivation_time > self._contacts[index + 1].activation_time
        ):
            return False
        self._contacts[index] = new_contact
        return True

    def get_present_contact(self, time: float) -> Optional[int]:
        """Index of the last contact with ``activation_time <= time``
        (``ContactList.cpp:190-202``); None if no such contact."""
        for i in range(len(self._contacts) - 1, -1, -1):
            if self._contacts[i].activation_time <= time:
                return i
        return None

    def keep_only_present_contact(self, time: float) -> bool:
        """Drop everything but the present contact (``ContactList.cpp:204-220``)."""
        idx = self.get_present_contact(time)
        if idx is None:
            return False
        present = self._contacts[idx]
        self.clear()
        return self.add_contact(present)

    def clear(self) -> None:
        self._contacts.clear()

    def remove_last_contact(self) -> None:
        self._contacts.pop()


@dataclass
class ContactPhase:
    """One phase of simultaneous contacts (``ContactPhase.h:24-50``):
    ``active_contacts`` maps list name → contact index in that list."""

    begin_time: float
    end_time: float
    active_contacts: Dict[str, int] = field(default_factory=dict)

    def is_list_included(self, key: str) -> bool:
        """``ContactPhase::isListIncluded`` (``ContactPhase.cpp:13-16``)."""
        return key in self.active_contacts


class ContactPhaseList:
    """Phase segmentation of several contact lists (``ContactPhaseList.h:32-141``)."""

    def __init__(self):
        self._lists: Dict[str, ContactList] = {}
        self._phases: List[ContactPhase] = []

    def set_lists(self, lists) -> bool:
        """Accepts a mapping name → ContactList or an iterable of ContactLists
        keyed by their ``default_name`` (both ``setLists`` overloads,
        ``ContactPhaseList.cpp:86-109``); duplicate names reject."""
        if isinstance(lists, Mapping):
            self._lists = dict(lists)
        else:
            self._lists = {}
            for lst in lists:
                if lst.default_name in self._lists:
                    self._lists = {}
                    return False
                self._lists[lst.default_name] = lst
        self._create_phases()
        return True

    def lists(self) -> Dict[str, ContactList]:
        return self._lists

    def _create_phases(self) -> None:
        """Two-event-map sweep, ported semantics of ``createPhases``
        (``ContactPhaseList.cpp:16-84``)."""
        self._phases = []
        activations: Dict[float, Dict[str, int]] = {}
        deactivations: Dict[float, Dict[str, int]] = {}
        for key, lst in self._lists.items():
            for i, c in enumerate(lst):
                activations.setdefault(c.activation_time, {})[key] = i
                deactivations.setdefault(c.deactivation_time, {})[key] = i
        if not activations:
            return

        act_times = sorted(activations)
        deact_times = sorted(deactivations)
        ai, di = 0, 0

        current = ContactPhase(
            begin_time=act_times[0],
            end_time=np.inf,
            active_contacts=dict(activations[act_times[0]]),
        )
        ai += 1

        while (len(act_times) - ai) + (len(deact_times) - di) > 1:
            if ai >= len(act_times) or deact_times[di] <= act_times[ai]:
                t = deact_times[di]
                current.end_time = t
                self._phases.append(current)
                current = ContactPhase(
                    begin_time=t, end_time=np.inf,
                    active_contacts=dict(current.active_contacts),
                )
                for name in deactivations[t]:
                    current.active_contacts.pop(name, None)
                di += 1
                if ai < len(act_times) and di < len(deact_times) and deact_times[di] == act_times[ai]:
                    # note: reference checks the *next* deactivation against the
                    # next activation here (ContactPhaseList.cpp:60-66)
                    current.active_contacts.update(activations[act_times[ai]])
                    ai += 1
            else:
                t = act_times[ai]
                current.end_time = t
                self._phases.append(current)
                current = ContactPhase(
                    begin_time=t, end_time=np.inf,
                    active_contacts=dict(current.active_contacts),
                )
                current.active_contacts.update(activations[t])
                ai += 1

        assert len(deact_times) - di == 1
        current.end_time = deact_times[di]
        self._phases.append(current)

    # -- access --------------------------------------------------------------
    def __len__(self) -> int:
        return len(self._phases)

    def __iter__(self):
        return iter(self._phases)

    def __getitem__(self, index: int) -> ContactPhase:
        return self._phases[index]

    def first_phase(self) -> ContactPhase:
        return self._phases[0]

    def last_phase(self) -> ContactPhase:
        return self._phases[-1]

    def clear(self) -> None:
        self._lists = {}
        self._phases = []


# ---------------------------------------------------------------------------
# Dense lowering for device consumption
# ---------------------------------------------------------------------------

class ContactScheduleArrays(NamedTuple):
    """Fixed-shape view of a contact schedule (SURVEY.md §7).

    All arrays have leading axes ``(num_effectors, num_knots)``; batched code
    indexes them with knot indices and never sees the phase structure.
    """

    names: Tuple[str, ...]
    times: np.ndarray      # (T,) knot times
    active: np.ndarray     # (E, T) bool — contact active at knot
    position: np.ndarray   # (E, T, 3) pose of present-or-next contact
    rotation: np.ndarray   # (E, T, 3, 3)
    contact_index: np.ndarray  # (E, T) int — which contact in the list (-1: before first)


def lower_contact_schedule(
    lists: Mapping[str, ContactList],
    dt: float,
    horizon: int,
    t0: float = 0.0,
) -> ContactScheduleArrays:
    """Lower contact lists to dense per-knot activation masks and footholds.

    For each knot ``t = t0 + k·dt`` and effector: ``active`` iff some contact
    window contains ``t`` (activation ≤ t < deactivation); the pose/index are
    those of the *present* contact (reference ``getPresentContact`` semantics,
    ``ContactList.cpp:190-202``) or of the first upcoming contact before any
    activation (so swing-target kernels always have a valid foothold).
    """
    names = tuple(sorted(lists))
    T, E = int(horizon), len(names)
    times = t0 + dt * np.arange(T)
    active = np.zeros((E, T), dtype=bool)
    position = np.zeros((E, T, 3))
    rotation = np.tile(np.eye(3), (E, T, 1, 1))
    contact_index = np.full((E, T), -1, dtype=np.int64)

    for e, name in enumerate(names):
        lst = lists[name]
        if len(lst) == 0:
            continue
        acts = np.array([c.activation_time for c in lst])
        deacts = np.array([c.deactivation_time for c in lst])
        idx = np.searchsorted(acts, times, side="right") - 1  # present contact
        present = idx >= 0
        contact_index[e] = idx
        active[e] = present & (times < deacts[np.clip(idx, 0, None)])
        pose_idx = np.where(present, idx, 0)  # before first contact: first foothold
        position[e] = np.stack([lst[i].position for i in pose_idx])
        rotation[e] = np.stack([lst[i].rotation for i in pose_idx])

    return ContactScheduleArrays(
        names=names, times=times, active=active, position=position,
        rotation=rotation, contact_index=contact_index,
    )
