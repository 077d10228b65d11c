"""Device idle milliseconds a call charged to the program's own spans: the
idle time a call of the device-only stretch, (window - busy) / calls, times
the share of the host stretch's idle gaps whose innermost host operation was
a span of the program (``search`` or a path under ``search/``: the facade's
spans and the search's device phases, which the program opens as profiler
ranges while a profiler records).  The first stretch says how long the
device waits, the second whom it waits for (``bench/devtrace.py``).  A
program that opens no such range gives nothing to read."""

SPAN = "search"


def read(ctx):
    tr = ctx.trace
    if tr is None or tr.calls <= 0 or tr.busy_s <= 0:
        return None
    idle_s = tr.window_s - tr.busy_s
    gaps_s = sum(tr.idle_gaps.values())
    own_s = sum(sec for name, sec in tr.idle_gaps.items()
                if name == SPAN or name.startswith(SPAN + "/"))
    if idle_s <= 0 or gaps_s <= 0 or own_s <= 0:
        return None
    return idle_s / tr.calls * (own_s / gaps_s) * 1e3
