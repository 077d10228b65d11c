"""The program's own ``ingest`` span, its median over the calls of a stream
that writes (``OverlapIndex.metrics()``'s registry): the host time a batch
takes to be routed to its indexes (K2) and appended to their delta buckets,
until the write is acknowledged.  A rebuild that a full delta bucket forces
inside the write counts in it too."""


def read(ctx):
    p50 = ctx.program.get("ingest_p50_s")
    return None if not p50 else p50 * 1e3
