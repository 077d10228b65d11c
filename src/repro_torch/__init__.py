"""PyTorch + CUDA port of the overlap-optimized kNN forest (``repro``).

The module layout mirrors ``src/repro``: ``kernels`` (plain versions, the
hand-written Hopper kernels and their dispatch), ``core`` (DBSCAN, overlap
rates, the decision stage, BCCF build, forest flattening, the bounded forest
search), ``data``, ``api`` (the ``OverlapIndex`` facade), and kNN-LM
serving: ``configs``, ``models`` (the dense GQA LM), ``serve`` (flat
datastores, the serving engine), ``obs`` (metrics and traces) and
``launch``.  This package imports ``torch`` and numpy only.

    from repro_torch.api import OverlapIndex

    ix = OverlapIndex.build(x, cfg)        # the overlap forest, on "cuda"
    ix = OverlapIndex.baseline(x)          # BCCF baseline, on "cuda"
    res = ix.search(q, k=10, beam=4)       # SearchResult: dists / ids / stats

    python -m repro_torch.launch.serve --arch qwen2-0.5b --full-size-model
"""
