"""The port's container utilities and checkpoints (``utils/containers.py``,
``utils/checkpoint.py``) against ``blf_tpu.utils``.

* Containers: the views, the structure predicates, the bounded flatten and
  the tree flatten's leaf order and paths match the reference on the same
  inputs (``tests/test_utils_aux.py``'s cases, exact).
* Checkpoints: a file ``blf_tpu`` writes loads in the port and the reverse,
  leaf for leaf bit-identical, with the same paths recorded; a count or
  shape mismatch raises; and examples/05_fleet_sweep.py's check with the
  port's fleet tick on the CPU (small B, 3 + 2 ticks): the fleet resumed
  from the checkpoint is bitwise equal.
"""

import json
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blf_tpu.parallel import sweep as jsweep
from blf_tpu.utils import checkpoint as jckpt
from blf_tpu.utils import containers as jcont
from blf_tpu_torch.parallel import sweep as tsweep
from blf_tpu_torch.problems import stationary_push_recovery
from blf_tpu_torch.utils import checkpoint as tckpt
from blf_tpu_torch.utils import containers as tcont

torch.set_num_threads(1)


class Pose(NamedTuple):
    position: object
    rotation: object


def nested(xp, rng):
    """The same nested tree (NamedTuple, dict with unsorted keys, list,
    tuple, None) in either package's arrays."""
    a = lambda *shape: xp(rng.normal(size=shape))
    return {"z": [a(2), (a(3, 2), None)], "a": Pose(a(3), a(3, 3)), "m": a()}


def test_tree_flatten_order_and_paths_are_jax():
    port = nested(lambda v: torch.as_tensor(np.array(v)), np.random.default_rng(0))
    ref = nested(jnp.asarray, np.random.default_rng(0))
    paths, treedef = tcont.tree_flatten_with_path(port)
    ref_paths = jax.tree_util.tree_flatten_with_path(ref)[0]
    assert [p for p, _ in paths] == [jax.tree_util.keystr(k) for k, _ in ref_paths]
    for (_, got), (_, want) in zip(paths, ref_paths):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    rebuilt = tcont.tree_unflatten(treedef, [leaf for _, leaf in paths])
    assert tcont.same_structure(rebuilt, port) and isinstance(rebuilt["a"], Pose)
    assert tcont.tree_size(port) == jcont.tree_size(ref)
    np.testing.assert_array_equal(tcont.tree_concat(port).numpy(),
                                  np.asarray(jcont.tree_concat(ref)))


def test_flat_views_match_the_reference():
    layout = {"com": (3,), "rot": (3, 3), "scalar": ()}
    views, total = tcont.make_view(layout)
    ref_views, ref_total = jcont.make_view(layout)
    assert total == ref_total == 13 and views == ref_views
    for flat in (np.arange(13.0), np.arange(39.0).reshape(3, 13)):
        for name in layout:
            np.testing.assert_array_equal(views[name].read(torch.as_tensor(flat)).numpy(),
                                          np.asarray(ref_views[name].read(jnp.asarray(flat))))
        value = np.full(3, 9.0)
        t_flat = torch.as_tensor(flat)
        written = views["com"].write(t_flat, torch.as_tensor(value))
        np.testing.assert_array_equal(
            written.numpy(), np.asarray(ref_views["com"].write(jnp.asarray(flat), value)))
        np.testing.assert_array_equal(t_flat.numpy(), flat)      # out of place


def test_structure_predicates_match_the_reference():
    for xp, module in ((jnp, jcont), (None, tcont)):
        z = (lambda s: jnp.zeros(s)) if xp else (lambda s: torch.zeros(s))
        o = (lambda s: jnp.ones(s)) if xp else (lambda s: torch.ones(s))
        a = {"x": z(3), "y": (o((2, 2)),)}
        b = {"x": o(3), "y": (z((2, 2)),)}
        c = {"x": o(4), "y": (z((2, 2)),)}
        d = {"x": o(3), "y": [z((2, 2))]}
        answers = [module.same_structure(a, b), module.same_structure(a, c),
                   module.same_structure(a, d), module.is_resizable_like([1, 2]),
                   module.is_resizable_like(np.zeros(3)), module.is_resizable_like(z(3)),
                   module.is_resizable_like((1, 2))]
        assert answers == [True, False, False, True, True, False, False]


def test_bounded_flatten_matches_the_reference():
    rng = np.random.default_rng(1)
    leaves = {"a": rng.normal(size=2), "b": rng.normal(size=(2, 2))}
    port = {k: torch.as_tensor(v) for k, v in leaves.items()}
    ref = {k: jnp.asarray(v) for k, v in leaves.items()}
    padded, n = tcont.flatten_bounded(port, capacity=10, fill=-1.0)
    ref_padded, ref_n = jcont.flatten_bounded(ref, capacity=10, fill=-1.0)
    assert n == ref_n == 6
    np.testing.assert_array_equal(padded.numpy(), np.asarray(ref_padded))
    back = tcont.unflatten_bounded(port, padded)
    for k in leaves:
        np.testing.assert_array_equal(back[k].numpy(), leaves[k])
        assert back[k].dtype == port[k].dtype
    with pytest.raises(ValueError, match="exceeds capacity"):
        tcont.flatten_bounded(port, capacity=4)
    with pytest.raises(ValueError, match="exceeds capacity"):
        jcont.flatten_bounded(ref, capacity=4)


def random_fleet(rng, B=4, N=8, M=48):
    """A fleet state's fields, drawn (so that equality means something)."""
    return dict(dcm=rng.normal(size=(B, 2)), com=rng.normal(size=(B, 2)),
                warm_zmp=rng.normal(size=(B, N, 2)), warm_y=rng.normal(size=(B, M)),
                offset_theta=rng.normal(size=(B, 2)), offset_cov=rng.normal(size=(B, 2, 2)),
                warm_s=rng.uniform(0.5, 2.0, (B, 1)))


def test_checkpoints_cross_between_the_packages(tmp_path):
    fields = {k: v.astype(np.float32) for k, v in random_fleet(np.random.default_rng(2)).items()}
    jax_state = jsweep.FleetState(**{k: jnp.asarray(v) for k, v in fields.items()})
    example = tsweep.init_fleet(4, 8, 48, [0.0, 0.0], [0.0, 0.0], device="cpu")

    written_by_jax = str(tmp_path / "jax.npz")
    jckpt.save_checkpoint(written_by_jax, jax_state, step=13)
    loaded = tckpt.load_checkpoint(written_by_jax, example)
    assert isinstance(loaded, tsweep.FleetState) and tckpt.checkpoint_step(written_by_jax) == 13
    for name, value in fields.items():
        got = getattr(loaded, name)
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), value)

    written_by_port = str(tmp_path / "port.npz")
    tckpt.save_checkpoint(written_by_port, loaded, step=14)
    back = jckpt.load_checkpoint(written_by_port, jax_state)
    assert jckpt.checkpoint_step(written_by_port) == 14
    for name, value in fields.items():
        np.testing.assert_array_equal(np.asarray(getattr(back, name)), value)
    meta = []
    for p in (written_by_jax, written_by_port):
        with open(p + ".meta.json", encoding="utf-8") as f:
            meta.append(json.load(f))
    assert meta[0]["paths"] == meta[1]["paths"] and meta[1]["num_leaves"] == 7


def test_checkpoint_mismatches_raise(tmp_path):
    path = str(tmp_path / "x.npz")
    tckpt.save_checkpoint(path, {"a": torch.zeros(3)})
    with pytest.raises(ValueError, match="shape"):
        tckpt.load_checkpoint(path, {"a": torch.zeros(4)})
    with pytest.raises(ValueError, match="leaves"):
        tckpt.load_checkpoint(path, {"a": torch.zeros(3), "b": torch.zeros(1)})
    assert tckpt.checkpoint_step(str(tmp_path / "missing.npz")) is None


def test_resumed_fleet_is_bitwise_equal(tmp_path):
    """examples/05_fleet_sweep.py's check with the port's fleet tick on the
    CPU: 3 ticks, a checkpoint, 2 more; the checkpoint loaded and the same 2
    ticks again."""
    B, N = 16, 8
    problem = stationary_push_recovery(B, N, seed=0, device="cpu", dtype=torch.float32)
    state = tsweep.init_fleet(B, N, problem.num_constraints, problem.dcm0, problem.com0,
                              device="cpu", dtype=torch.float32)
    step = tsweep.make_fleet_step(problem.params, problem.dt, iterations=50, device="cpu")
    refs = (problem.dcm_ref, problem.zmp_ref, problem.poly_A, problem.poly_b)

    def run(state, ticks):
        for _ in range(ticks):
            state, _ = step(state, problem.disturbance, *refs)
        return state

    state = run(state, 3)
    path = str(tmp_path / "fleet.npz")
    tckpt.save_checkpoint(path, state, step=3)
    final = run(state, 2)
    resumed = tckpt.load_checkpoint(path, state)
    refinal = run(resumed, 2)
    assert tckpt.checkpoint_step(path) == 3
    for a, b in zip(tcont.tree_leaves(final), tcont.tree_leaves(refinal)):
        assert torch.equal(a, b)
