"""The port's optimizers and LR schedule (the JAX package's ``repro/optim``)."""
from repro_torch.optim.optimizer import (
    Optimizer,
    adafactor,
    adamw,
    clip_by_global_norm,
    get_optimizer,
)
from repro_torch.optim.schedule import cosine_with_warmup

__all__ = [
    "Optimizer", "adafactor", "adamw", "clip_by_global_norm", "get_optimizer",
    "cosine_with_warmup",
]
