"""Where the port's entry points run: ``cuda`` unless the caller names a
device.  The facade (``api/index.py``), the build stages (``core/``) and
serving all resolve their ``device=`` argument here."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The torch device an entry point runs on: ``cuda`` unless the caller
    names one.  Without CUDA, an unnamed device is an error, never a quiet
    fall back to the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; repro_torch runs on the card by "
            "default — pass device='cpu' to run the plain versions on the host"
        )
    return torch.device("cuda")
