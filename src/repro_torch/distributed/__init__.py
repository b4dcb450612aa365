"""Distribution for the port: the sharding rules as DTensor placements
(``sharding.py``), activation constraints and the weights' gathers
(``constraints.py``), the sharded train step (``sharded_step.py``), the
remat policies (``remat.py``), and the dry-run's accounting
(``collectives.py``, ``trace_analysis.py``)."""
