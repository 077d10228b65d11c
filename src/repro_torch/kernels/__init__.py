"""Plain versions (``ref``), hand-written CUDA kernels (``pairwise_l2``,
``bucket_scan``, sources under ``csrc/``) and the dispatch layer (``ops``)."""
