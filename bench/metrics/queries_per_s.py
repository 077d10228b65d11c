"""Queries answered in the window over the window's wall time (host clock).
Each call ends when the search has returned host arrays."""


def read(ctx):
    return ctx.window.queries / ctx.window.wall_s
