"""``dispatch_ms``: host milliseconds to enqueue one step, read on the host
clock around the step's call after the window, each step started on an
idle card so that no full launch queue blocks the call."""


def read(ctx):
    return ctx.dispatch_ms
