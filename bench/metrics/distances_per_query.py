"""(query, row) distances the search reports (its ``distances`` statistic, the
paper's cost currency), summed by the program's counters over the window,
over the window's queries."""


def read(ctx):
    q = ctx.program.get("queries")
    return None if not q else ctx.program["distances"] / q
