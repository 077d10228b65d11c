"""Device kernel launches in the traced calls over the number of calls (copies
and fills not counted)."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.kernels:
        return None
    return len(tr.kernels) / tr.calls
