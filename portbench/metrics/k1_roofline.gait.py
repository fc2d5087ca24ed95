"""`k1_roofline.gait`: kernel K1 (`admm_stage`), the stage's least time (useful
FLOPs at the bf16 peak or bytes at the HBM bandwidth, `portbench.peaks`) over
the device time of what its calls launched, in percent; see
`portbench.readers.roofline_pct`."""
from portbench import peaks, readers

SPANS = ["blf_tpu_torch.mpc.qp:admm_stage"]


def bound_s(call):
    """``admm_stage(v, tau, s, gq, l, u, G2, ..., iters=)``: v is (B, m), G2 (m, n)."""
    (B, m), n = call.shapes[0], call.shapes[6][1]
    return peaks.k1_bound_s(B, m, n, call.ints["iters"])


def read(ctx):
    return readers.roofline_pct(ctx, SPANS[0], bound_s)
