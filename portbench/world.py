"""The ranks of a cell that spans several chips.

Rank 0 is the process the command started. It picks a free localhost port
and starts ranks 1 .. n-1 as plain subprocesses of the same command line,
which find their rank in ``PORTBENCH_RANK`` and the meeting point in
``PORTBENCH_ADDR``; each rank takes card ``rank`` and starts the
``torch.distributed`` world (``nccl`` on the cards, ``gloo`` on the CPU)
that the program's mesh then finds already up. NCCL's
shared-memory transport is off (``NCCL_SHM_DISABLE=1``): the cards talk over
NVLink and nothing is written to ``/dev/shm``. A ``gloo`` group of its own
carries the benchmark's control: rank 0's decision to run another unit, and
the sums and maxima of what each rank read. Only rank 0 prints a result; it
waits for every rank it started.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
from datetime import timedelta
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

__all__ = ["World", "RANK_VAR", "ADDR_VAR", "free_address", "start_ranks", "stop_ranks",
           "this_rank", "argv_of_this_process"]

RANK_VAR = "PORTBENCH_RANK"
ADDR_VAR = "PORTBENCH_ADDR"
#: every collective of a world, the program's too
TIMEOUT = timedelta(seconds=180)


def free_address() -> str:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return f"tcp://127.0.0.1:{s.getsockname()[1]}"


def start_ranks(argv: Sequence[str], size: int, address: str) -> List[subprocess.Popen]:
    """Ranks 1 .. size-1 as subprocesses of ``argv`` (rank 0 is the caller)."""
    os.environ["NCCL_SHM_DISABLE"] = "1"
    procs = []
    for rank in range(1, size):
        env = dict(os.environ, **{RANK_VAR: str(rank), ADDR_VAR: address})
        procs.append(subprocess.Popen(list(argv), env=env, stdout=subprocess.DEVNULL))
    return procs


def stop_ranks(procs: List[subprocess.Popen], timeout: float) -> List[Optional[int]]:
    """Wait for the started ranks, killing any that outlive ``timeout``."""
    codes = []
    for p in procs:
        try:
            codes.append(p.wait(timeout=timeout))
        except subprocess.TimeoutExpired:
            p.kill()
            codes.append(p.wait())
    return codes


class World:
    """This process's rank among ``size``, met at ``address``."""

    def __init__(self, rank: int, size: int, address: str, device: torch.device):
        self.rank, self.size, self.device = rank, size, device
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo", init_method=address,
                                world_size=size, rank=rank, timeout=TIMEOUT)
        self.control = dist.new_group(backend="gloo", timeout=TIMEOUT)

    def agree(self, go: bool) -> bool:
        """Rank 0's ``go``, on every rank."""
        flag = torch.tensor([int(go)])
        dist.broadcast(flag, 0, group=self.control)
        return bool(flag.item())

    def _reduce(self, values: Sequence[float], op) -> List[float]:
        t = torch.tensor([float(v) for v in values], dtype=torch.float64)
        dist.all_reduce(t, op=op, group=self.control)
        return t.tolist()

    def sum(self, values: Sequence[float]) -> List[float]:
        return self._reduce(values, dist.ReduceOp.SUM)

    def max(self, values: Sequence[float]) -> List[float]:
        return self._reduce(values, dist.ReduceOp.MAX)

    def close(self) -> None:
        dist.barrier(group=self.control)
        dist.destroy_process_group()


def this_rank() -> int:
    return int(os.environ.get(RANK_VAR, "0"))


def argv_of_this_process() -> List[str]:
    return [sys.executable] + sys.argv
