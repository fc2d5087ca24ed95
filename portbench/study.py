"""Readings for the limits of ``correct``: the compared numbers of the
program and of the control over many seeds, in one process.

    python3 portbench/study.py --workload <cell> --seeds 1,2,3 --units 40 [--out file]

For each seed: the cell's set-up from that seed, its warm-up, ``--units``
units through the timed path, then the sampled units judged twice against
the float64 reference: the program's outputs (the lower readings of each
limit), and the control's, the reference in the program's place with both
products of every ADMM iteration on bfloat16 operands (the upper readings).
Prints one JSON line a seed. The benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main(argv):
    import torch

    from portbench.harness import driver_class, load_cell
    from portbench.world import (ADDR_VAR, World, argv_of_this_process, free_address,
                                 start_ranks, stop_ranks, this_rank)

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--units", type=int, default=40)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("study: no CUDA device", file=sys.stderr)
        return 3
    torch.set_num_threads(4)
    cell = load_cell(args.workload)
    rank, world, ranks = this_rank(), None, []
    device = torch.device("cuda", rank)
    torch.cuda.set_device(device)
    if cell.chips > 1:           # the ranks of a cell on several chips, as a run starts them
        address = os.environ.get(ADDR_VAR) or free_address()
        if rank == 0:
            ranks = start_ranks(argv_of_this_process(), cell.chips, address)
        world = World(rank, cell.chips, address, device)
    worst = (lambda d: d) if world is None else (
        lambda d: dict(zip(sorted(d), world.max([d[k] for k in sorted(d)]))))
    cls = driver_class(cell.config)
    out = open(args.out, "a") if args.out and rank == 0 else None
    try:
        for seed in (int(s) for s in args.seeds.split(",")):
            t0 = time.perf_counter()
            driver = cls(cell.config, cell.traffic, seed, device, world=world)
            driver.warm()
            driver.begin_window()
            failed = 0
            for _ in range(args.units):
                failed += driver.unit()[1]
            driver.release()
            line = {"workload": cell.name, "seed": seed, "units": args.units, "failed": failed,
                    "program": worst(driver.compare("float64")),
                    "control": worst(driver.compare("bfloat16")),
                    "seconds": time.perf_counter() - t0}
            if rank == 0:
                print(json.dumps(line), flush=True)
            if out:
                out.write(json.dumps(line) + "\n")
                out.flush()
            del driver
            torch.cuda.empty_cache()
        if world is not None:
            world.close()
    finally:
        stop_ranks(ranks, timeout=120)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
