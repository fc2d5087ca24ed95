"""`planner_ops.gait`: the gait planner's own device operations, launched
under the program's schedule, hulls, references, transcription and rollout
spans, a plan; see `portbench.program_spans.ops`."""
from portbench import program_spans

SPANS = []
PROGRAM_SPANS = ["gait.schedule", "gait.hulls", "gait.references", "dcm.transcribe",
                 "dcm.rollout"]


def read(ctx):
    return program_spans.ops(ctx, PROGRAM_SPANS)
