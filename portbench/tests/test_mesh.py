"""A four-chip cell driven on the CPU: four ``gloo`` ranks in spawned
processes, each its shard of ``push_recovery.mesh2x2`` at a small size (a
held cell: ``conftest.HELD``),
through the harness's window and checks. With the exchange between the
ranks left out (the tick's ``psum_tree``/``pmax_tree`` returning the rank's
own values), the run comes out not correct; the control (the reference in
the program's place, products on bfloat16 operands) fails the cell's limits
where the program holds them."""

import json
import multiprocessing
import time

import pytest

from portbench.world import free_address

SIZE = 4
CELL = "push_recovery.mesh2x2"


def _rank(rank, address, fault, out):
    import torch

    torch.set_num_threads(1)
    if fault == "no_exchange":
        import blf_tpu_torch.parallel.sweep as sweep

        sweep.psum_tree = lambda tree, group: tree
        sweep.pmax_tree = lambda tree, group: tree
    from conftest import small_cell

    from portbench.harness import execute
    from portbench.world import World

    world = World(rank, SIZE, address, torch.device("cpu"))
    cell = small_cell(CELL, 16)
    if fault == "control":
        from portbench.harness import driver_class

        d = driver_class(cell.config)(cell.config, cell.traffic, 2 ** 31 + 78,
                                      torch.device("cpu"), world=world)
        d.warm()
        d.begin_window()
        for _ in range(4):
            d.unit()
        d.release()
        worst = lambda r: dict(zip(sorted(r), world.max([r[k] for k in sorted(r)])))
        result = {"program": worst(d.compare("float64")), "control": worst(d.compare("bfloat16")),
                  "limits": cell.limits}
    else:
        result = execute(cell, 2 ** 31 + 77, 0.5, False, torch.device("cpu"),
                         time.perf_counter(), world=world)
    world.close()
    with open(f"{out}/{rank}.json", "w") as f:
        json.dump(result, f)


def run_world(fault, tmp_path):
    ctx = multiprocessing.get_context("spawn")
    address = free_address()
    procs = [ctx.Process(target=_rank, args=(r, address, fault, str(tmp_path)), daemon=True)
             for r in range(SIZE)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + 300
    for p in procs:
        p.join(max(1.0, deadline - time.monotonic()))
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
    assert not alive and all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    return [json.loads((tmp_path / f"{r}.json").read_text()) for r in range(SIZE)]


@pytest.mark.parametrize("fault", [None, "no_exchange"])
def test_four_ranks_on_the_cpu(fault, tmp_path):
    results = run_world(fault, tmp_path)
    assert all(r["checks"] == results[0]["checks"] for r in results)
    first = results[0]
    assert first["attempted"] > 0 and first["attempted"] % (SIZE * 16) == 0
    assert first["correct"] is (fault is None), first["checks"]


def test_control_fails_and_program_holds_on_four_ranks(tmp_path):
    r = run_world("control", tmp_path)[0]
    failing = lambda numbers: sorted(k for k, lim in r["limits"].items() if not numbers[k] <= lim)
    assert failing(r["program"]) == [], r["program"]
    assert failing(r["control"]), r["control"]
