"""Compiled programs: programs built (captured) during the window, the
rise of ``compile_count()``; 0 when warm-up covered every shape."""


def read(ctx):
    return ctx.delta("compile_count")
