"""The LM trainer (``train_step``, ``optimizer``, ``compression``,
``fault_tolerance.RestartableLoop``), the serve steps, and the snapshots
and fault injection of the resumable GPIC supervisor (``checkpoint``,
``fault_tolerance``)."""
from .optimizer import AdamWState, adamw_init, adamw_update, lr_schedule
from .train_step import build_train_step, loss_fn

__all__ = [
    "adamw_init", "adamw_update", "AdamWState", "lr_schedule",
    "build_train_step", "loss_fn",
]
