"""Index and planner: shortlist overflows of the fused two-phase path
during the window (the rise of ``ShortlistHints.overflows``)."""


def read(ctx):
    return ctx.delta("shortlist_overflows")
