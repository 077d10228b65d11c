"""The program's own ``search/device_execute`` span, its median over the
window (``OverlapIndex.metrics()``): the host time the facade spends handing
the queries to the device and enqueueing the search's operations.  It does
not wait for the device, so it is host enqueue time, not device time."""


def read(ctx):
    p50 = ctx.program.get("device_execute_p50_s")
    return None if not p50 else p50 * 1e3
