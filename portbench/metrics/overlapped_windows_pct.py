"""Service layer: the share of the window's dispatches made while an
earlier window was still in flight (double buffering), in percent."""


def read(ctx):
    windows = ctx.delta("windows")
    if not windows:
        return None
    return 100.0 * ctx.delta("overlapped_windows") / windows
