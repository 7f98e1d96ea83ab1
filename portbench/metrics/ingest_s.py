"""Index and planner: seconds of the lake's ``add`` calls and the first
``plan()`` of each target type (the device flush), on the benchmark's
clock."""


def read(ctx):
    return ctx.setup.get("ingest_s")
