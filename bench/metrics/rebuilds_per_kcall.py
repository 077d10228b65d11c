"""Indexes rebuilt in the window (the program's ``maintain.rebuilds``
counter, which counts each index a rebuild swaps in) per 1,000 calls."""


def read(ctx):
    calls = ctx.program.get("calls")
    return None if not calls or "rebuilds" not in ctx.program else (
        ctx.program["rebuilds"] / calls * 1e3)
