"""`syncs.gait`: the program's host waits for the device, its `sync.*` spans
inside `gait.plan`, a plan; see `portbench.program_spans.count`."""
from portbench import program_spans

SPANS = []
PROGRAM_SPANS = ["gait.plan", "sync.*"]


def read(ctx):
    return program_spans.count(ctx, PROGRAM_SPANS[1], root=PROGRAM_SPANS[0])
