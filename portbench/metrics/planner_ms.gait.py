"""`planner_ms.gait`: the gait planner's own part of a plan (schedule, hulls,
references, transcription): `plan_gait`'s device-clock time from entry to
return less the factorization's and the solve's inside it; see
`portbench.readers.rest_ms`."""
from portbench import readers

SPANS = ["blf_tpu_torch.planners.gait:plan_gait", "blf_tpu_torch.mpc.dcm:factor_shared_qp", "blf_tpu_torch.mpc.dcm:solve_qp_factored"]


def read(ctx):
    return readers.rest_ms(ctx, SPANS[0], SPANS[1:])
