"""Fleet-level programs (counterpart of ``blf_tpu/parallel``).

Ported for one device: ``collectives`` (``FleetStats``, ``reduce_fleet_stats``)
and ``sweep`` (the fleet tick). Not yet ported: ``mesh``, ``pipeline`` and
everything that spans devices.
"""
