"""`solves_per_s`: see `portbench.readers.lanes_per_s`."""
from portbench.readers import lanes_per_s as read  # noqa: F401
