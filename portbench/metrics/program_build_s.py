"""Compiled programs: seconds spent warming up and capturing programs by
the end of set-up (``compile_stats()["build_s"]``)."""


def read(ctx):
    return ctx.setup.get("program_build_s")
