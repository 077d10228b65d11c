"""Benchmark of ``repro_torch``, the PyTorch + CUDA port of the overlap-optimized
kNN forest.

``python bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line.  Everything
that belongs to one configuration, traffic mix, metric or kernel role lives in
a file of its own that the harness finds by name (``catalog.py``):

* ``configs/<config>.json``   a deployment: dataset, build and search settings
                              (the search mode among them), its reference,
                              the limits of the correctness check;
* ``traffic/<mix>.json``      a traffic mix, read by ``traffic.py``;
* ``metrics/<metric>.py``     one reader per metric (the part of the name
                              before the first dot);
* ``layers/*.json``           kernel-name patterns and the role of each; all
                              files are merged.

The yardstick is frozen here: the dataset generators (``datasets.py``), the
query recipe (``traffic.py``), the roofline arithmetic (``roofline.py``), the
trace reduction (``devtrace.py``) and the plain reference with the comparison
that decides ``correct`` (``reference/``).
"""
