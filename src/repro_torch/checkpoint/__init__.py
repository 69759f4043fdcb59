"""Checkpoints in the reference's file format (port of `repro.checkpoint`)."""
from repro_torch.checkpoint.io import (
    CheckpointError,
    load_meta,
    load_pytree,
    restore_fleet_checkpoint,
    restore_train_state,
    save_fleet_checkpoint,
    save_pytree,
)

__all__ = ["CheckpointError", "save_pytree", "load_pytree", "load_meta",
           "restore_train_state", "save_fleet_checkpoint",
           "restore_fleet_checkpoint"]
