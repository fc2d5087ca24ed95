"""`glue_ops.tick`: the fleet tick's eager glue, the device operations
launched under the program's transcription, rollout, statistics, advance,
RLS and status spans, a tick; see `portbench.program_spans.ops`."""
from portbench import program_spans

SPANS = []
PROGRAM_SPANS = ["dcm.transcribe", "dcm.rollout", "fleet.stats", "fleet.advance", "fleet.rls",
                 "fleet.status"]


def read(ctx):
    return program_spans.ops(ctx, PROGRAM_SPANS)
