"""`solve_ms.gait`: the factored solve (`solve_qp_factored`: the ADMM stages and
their boundaries), device-clock time from its entry to its return, a plan;
see `portbench.readers.span_ms`."""
from portbench import readers

SPANS = ["blf_tpu_torch.mpc.dcm:solve_qp_factored"]


def read(ctx):
    return readers.span_ms(ctx, SPANS[0])
