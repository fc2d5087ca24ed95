"""`idle_pct.gait`: share of an untraced plan's time in which the device runs
nothing; see `portbench.readers.idle_pct`."""
from portbench import readers

SPANS = []


def read(ctx):
    return readers.idle_pct(ctx)
