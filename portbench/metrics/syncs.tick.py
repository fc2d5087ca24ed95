"""`syncs.tick`: the program's host waits for the device, its `sync.*` spans
inside `fleet.tick`, a tick; see `portbench.program_spans.count`."""
from portbench import program_spans

SPANS = []
PROGRAM_SPANS = ["fleet.tick", "sync.*"]


def read(ctx):
    return program_spans.count(ctx, PROGRAM_SPANS[1], root=PROGRAM_SPANS[0])
