"""`plan_ms_p95`: see `portbench.readers.unit_ms_p95`."""
from portbench.readers import unit_ms_p95 as read  # noqa: F401
