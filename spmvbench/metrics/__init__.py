"""One reader a metric, ``<metric name>.py``, each with ``read(run)``: the
metric's value from a :class:`~spmvbench.run.Run`, or ``None`` where the
run holds nothing to read (the harness then leaves the metric out)."""
