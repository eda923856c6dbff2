from repro_torch.ckpt.checkpoint import CheckpointManager, restore_checkpoint, save_checkpoint

__all__ = ["CheckpointManager", "save_checkpoint", "restore_checkpoint"]
