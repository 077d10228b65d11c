"""Seconds from the harness's first statement to the first timed call: the
imports, the dataset and query pool, the index build (DBSCAN on the card, the
trees on the host), the upload and the warm-up calls; in a run that finds
them unbuilt, the port's CUDA kernels' build too."""


def read(ctx):
    return ctx.setup_s
