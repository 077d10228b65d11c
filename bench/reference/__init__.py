"""The plain reference of the benchmark and the comparison that decides
``correct``.  Plain PyTorch, NumPy and SciPy; imports nothing of
``repro_torch`` or JAX."""
