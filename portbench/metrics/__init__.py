"""Per-layer metric readers: ``<metric>.py`` holds ``read(ctx)``, which
returns the metric's value from the traced run's context (see
``harness.Context``), or None when it finds nothing to read there.

A reader may also hold, for the traced run on the card:

* ``capture(index, batches, cfg)``: called once the window has closed
  and its programs are dropped, with the index and the train sketches
  of the window's first round, in the buckets the program took them;
  what it returns is ``ctx.captured`` when ``read`` runs;
* ``launches()`` and ``KERNEL``: the program's launch counter of a
  kernel and a part of its device records' name; the harness reports
  the kernel's records in the profiled slice beside the launches
  counted in it.
"""
