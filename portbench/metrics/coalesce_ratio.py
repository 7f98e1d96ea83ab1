"""Service layer: queries per dispatched bucket over the window, from
the scheduler's counters (``SchedulerStats``)."""


def read(ctx):
    buckets = ctx.delta("dispatched_buckets")
    if not buckets:
        return None
    return ctx.delta("coalesced_queries") / buckets
