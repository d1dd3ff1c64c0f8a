"""Step-atomic checkpoints in the reference's on-disk format."""
from repro_torch.checkpoint.checkpoint import (CheckpointError,
                                               CheckpointManager,
                                               committed_steps, latest_step,
                                               read_extra, restore_checkpoint,
                                               save_checkpoint)

__all__ = ["save_checkpoint", "restore_checkpoint", "read_extra",
           "latest_step", "committed_steps", "CheckpointError",
           "CheckpointManager"]
