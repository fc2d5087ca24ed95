"""`device_ops.gait`: device operations launched a plan, from the trace; see
`portbench.readers.device_ops`."""
from portbench import readers

SPANS = []


def read(ctx):
    return readers.device_ops(ctx)
