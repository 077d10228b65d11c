"""The share of the traced window in which no kernel, copy or fill ran on the
device: 100 (1 - union of their intervals / the window), from
``torch.profiler`` over a steady stretch of calls."""


def read(ctx):
    tr = ctx.trace
    if tr is None or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
