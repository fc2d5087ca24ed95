"""`factor_reuse.tick`: the ticks that reused the last tick's factorization,
the program's `dcm.factor_reused` spans inside `fleet.tick`, a tick (1 where
every tick reuses, 0 where every tick checks and factors anew); see
`portbench.program_spans.count`. A program that never checks whether it can
reuse its factors (no `sync.factor_key` span inside a tick) gives nothing to
read."""
from portbench import program_spans

SPANS = []
ROOT, CHECK, REUSED = "fleet.tick", "sync.factor_key", "dcm.factor_reused"


def read(ctx):
    if not program_spans.count(ctx, CHECK, root=ROOT):
        return None
    return program_spans.count(ctx, REUSED, root=ROOT)
