"""Fleet-level and multi-device programs (counterpart of ``blf_tpu/parallel``).

Everything of it is ported: ``mesh`` (the ``(data, model)`` device mesh on
``torch.distributed``, batch placement), ``collectives`` (``FleetStats``,
``reduce_fleet_stats``, the tree reductions across ranks), ``sweep`` (the
fleet tick, on one device or a mesh, with a disturbance ensemble) and
``pipeline`` (the GPipe stage pipeline).
"""
