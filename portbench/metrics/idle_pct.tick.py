"""`idle_pct.tick`: share of an untraced tick's time in which the device runs
nothing; see `portbench.readers.idle_pct`."""
from portbench import readers

SPANS = []


def read(ctx):
    return readers.idle_pct(ctx)
