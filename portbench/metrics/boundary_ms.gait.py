"""`boundary_ms.gait`: the factored solve's stage boundaries (residuals, the
penalty rule, v re-expressed), the union of the device intervals of the
operations launched under the program's `qp.boundary` spans, a plan; see
`portbench.program_spans.busy_ms`."""
from portbench import program_spans

SPANS = []
PROGRAM_SPANS = ["qp.boundary"]


def read(ctx):
    return program_spans.busy_ms(ctx, PROGRAM_SPANS)
