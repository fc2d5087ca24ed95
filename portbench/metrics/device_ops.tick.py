"""`device_ops.tick`: device operations launched a tick, from the trace; see
`portbench.readers.device_ops`."""
from portbench import readers

SPANS = []


def read(ctx):
    return readers.device_ops(ctx)
