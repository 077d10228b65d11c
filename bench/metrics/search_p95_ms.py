"""The 95th percentile of the wall time of every call in the window (host
clock; numpy's linear interpolation between order statistics)."""
import numpy as np


def read(ctx):
    return float(np.percentile(np.asarray(ctx.window.call_s), 95)) * 1e3
