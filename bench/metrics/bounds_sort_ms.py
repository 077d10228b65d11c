"""Device milliseconds a call in the kernels that ``bench/layers`` marks as
``bounds`` (the pivot distances) or ``sort`` (the stable sort of the lower
bounds), over the traced calls."""

ROLES = ("bounds", "sort")


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    times = [sec for name, sec in tr.kernels if ctx.role(name) in ROLES]
    return sum(times) / tr.calls * 1e3 if times else None
