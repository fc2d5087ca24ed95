"""The control comes out not correct and the program correct, under each
cell's limits: on the CPU at a size a test run holds, and (marked ``chip``)
at the cell's own size on three seeds."""

import pytest
import torch

from portbench.harness import driver_class, load_cell

from conftest import bench, small_cell

torch.set_num_threads(2)
CELLS = ["push_recovery.fleet98k", "full_gait.sweep16k", "push_recovery.rt4096",
         "push_recovery.ensemble2"]


def readings(cell, seed, device, units):
    d = driver_class(cell.config)(cell.config, cell.traffic, seed, device)
    d.warm()
    d.begin_window()
    for _ in range(units):
        d.unit()
    d.release()
    return d.compare("float64"), d.compare("bfloat16")


def failing(numbers, limits):
    return sorted(k for k, lim in limits.items() if not numbers[k] <= lim)


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_holds_on_the_cpu(cell):
    c = small_cell(cell, 16 if cell.startswith("full_gait") else 48)
    program, control = readings(c, 2 ** 31 + 99, torch.device("cpu"), 4)
    assert failing(program, c.limits) == [], program
    assert failing(control, c.limits), control


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_the_cells_size(cell, cuda_device):
    c = load_cell(cell, bench())
    for seed in (2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3):
        program, control = readings(c, seed, cuda_device, 20 if "push" in cell else 4)
        assert failing(program, c.limits) == [], (seed, program)
        assert failing(control, c.limits), (seed, control)
