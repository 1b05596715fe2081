"""Optimizers of the port (counterpart of ``repro.optim``)."""
from repro_torch.optim.adamw import (
    AdamWState,
    abstract_state,
    cosine_schedule,
    init,
    state_axes,
    update,
)

__all__ = ["AdamWState", "abstract_state", "cosine_schedule", "init",
           "state_axes", "update"]
