"""Synthetic datasets (numpy, seeded) mirroring the paper's benchmarks."""
