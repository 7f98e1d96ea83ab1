"""Executors and estimators: device milliseconds a query of the torch
kernel families the sketch join runs (searchsorted, gather, scatter,
advanced indexing) in the profiled slice, over the queries answered in
it.  The estimators' dense ranks and entropy counts run gathers and
scatters too, and are counted with them."""

FAMILIES = ("searchsorted", "gather", "scatter", "index_elementwise")


def read(ctx):
    tr = ctx.trace
    if not tr or not tr["queries"]:
        return None
    ms = sum(t - s for name, s, t in tr["kernels"]
             if any(f in name for f in FAMILIES)) / 1e3
    if ms <= 0:
        return None
    return ms / tr["queries"]
