"""`factor_ms.tick`: the factorization (`factor_shared_qp`: Ruiz, Cholesky, the
float64 `eigh` that synchronises), device-clock time from its entry to its
return, a tick; see `portbench.readers.span_ms`."""
from portbench import readers

SPANS = ["blf_tpu_torch.mpc.dcm:factor_shared_qp"]


def read(ctx):
    return readers.span_ms(ctx, SPANS[0])
