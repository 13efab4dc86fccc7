"""Checkpoints (port of ``repro.checkpoint``), in ``repro``'s layout."""
from repro_torch.checkpoint.ckpt import (AsyncCheckpointer, latest_step,
                                         restore_checkpoint, save_checkpoint)

__all__ = ["AsyncCheckpointer", "latest_step", "restore_checkpoint",
           "save_checkpoint"]
