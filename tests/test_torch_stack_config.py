"""``problems.STACK_R05`` is the configuration ``STACK_r05.json`` recorded.

``STACK_r05.json`` is the JAX package's record of its control-stack bench
(``benchmarks/stack_bench.py``) in its production configuration;
``detail.config`` lists the fields that bench set. The port's constant takes
the reference's backends by the port's names:

* ``"pallas"`` (the MPC's bf16 delta mode) -> ``"cuda_delta"``;
* ``"pallas_f32"`` -> ``"cuda"``;
* ``"xla"`` -> ``"torch"``;
* the WBC's ``"pallas"`` (the per-lane kernels) -> ``"cuda"``.

The test reads the JSON and the bench's source as text only: no JAX.
"""

import json
import re
from pathlib import Path

import pytest

from blf_tpu_torch.mpc.stack import StackConfig
from blf_tpu_torch.problems import STACK_R05, stack_fleet_step

ROOT = Path(__file__).resolve().parents[1]
RECORD = json.loads((ROOT / "STACK_r05.json").read_text())["detail"]["config"]
MPC_BACKENDS = {"pallas": "cuda_delta", "pallas_split": "cuda_split", "pallas_f32": "cuda",
                "xla": "torch"}
WBC_BACKENDS = {"pallas": "cuda", "xla": "torch"}
#: set by the bench (benchmarks/stack_bench.py) but not listed in the record
BENCH_ONLY = {"mpc_dt": 0.1, "wbc_scaling_iters": 4}


def recorded(field):
    value = RECORD[field]
    if field == "mpc_backend":
        return MPC_BACKENDS[value]
    if field == "wbc_backend":
        return WBC_BACKENDS[value]
    return value


@pytest.mark.parametrize("field", sorted(k for k in RECORD if k != "step"))
def test_every_recorded_field(field):
    assert field in StackConfig._fields
    assert getattr(STACK_R05, field) == recorded(field)


def test_the_mpc_runs_the_recorded_delta_mode():
    assert RECORD["mpc_backend"] == "pallas"
    assert STACK_R05.mpc_backend == "cuda_delta"


def test_the_recorded_step_is_the_fleet_step():
    import inspect

    assert RECORD["step"] == "fleet"
    assert "make_fleet_stack_step" in inspect.getsource(stack_fleet_step)


@pytest.mark.parametrize("field", sorted(BENCH_ONLY))
def test_fields_the_bench_sets_beside_the_record(field):
    source = (ROOT / "benchmarks" / "stack_bench.py").read_text()
    assert re.search(rf"\b{field}={BENCH_ONLY[field]!r}\b", source)
    assert getattr(STACK_R05, field) == BENCH_ONLY[field]


def test_every_other_field_keeps_the_reference_default():
    set_here = set(RECORD) | set(BENCH_ONLY)
    for field in StackConfig._fields:
        if field not in set_here:
            assert getattr(STACK_R05, field) == StackConfig._field_defaults[field], field
