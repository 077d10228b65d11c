"""Entry points of the port run as ``python -m repro_torch.launch.<name>``."""
