"""The search's own ``bound_distances`` counter over the window, over the
window's queries: the distances to the index centers that route a query and
the lower bounds of the buckets its routed indexes hold (the paper's node
accesses before the scan).  Without routing every bucket is bounded."""


def read(ctx):
    q = ctx.program.get("queries")
    return None if not q else ctx.program["bound_distances"] / q
