from repro_torch.checkpoint.checkpointer import latest_step, restore_checkpoint, save_checkpoint

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step"]
