"""The wall time of the window's rebuilds, in milliseconds a call: the sum of
the program's ``rebuild`` spans over the window (each covers the host's new
trees for the triggered indexes, their upload and the hot swap), over the
window's calls.  A window without a rebuild gives nothing to read."""


def read(ctx):
    calls = ctx.program.get("calls")
    rebuild_s = ctx.program.get("rebuild_s")
    return None if not calls or not rebuild_s else rebuild_s / calls * 1e3
