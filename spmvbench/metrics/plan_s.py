"""``plan_s``: the host plan build and upload of the first call in set-up:
``SpMVResult.plan_seconds``, or in a PageRank cell the first call's wall
time (its one solve inside; on a sharded cell with the shards' plans and
the dangling mask made before it)."""


def read(run):
    return run.plan_s if run.plan_s > 0 else None
